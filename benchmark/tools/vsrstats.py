"""What the seeded weights of an IconVSR cell make of its clip: the
percentiles of |offset| at each of EDVR's four DCNs on a keyframe clip,
and of |flow| on SpyNet's flows between consecutive frames, from the plain
fp32 reference on the cell's own inputs.  The benchmark's runs do not run it.

    python3 benchmark/tools/vsrstats.py --workload vsr_iconvsr_x4_540p --seeds 1,2 [--device cuda]

One JSON line a seed.
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

import torch  # noqa: E402

from benchmark.harness import spec, traffic  # noqa: E402
from benchmark.harness.weights import DTYPES, drawWeights  # noqa: E402
from benchmark.reference import iconvsr  # noqa: E402
from benchmark.reference.ifrnet import frameFromBytes  # noqa: E402
from benchmark.reference.layers import fp32Exact  # noqa: E402

QUANTILES = (0.5, 0.9, 0.99)


def percentiles(t: torch.Tensor) -> list:
    t = t.flatten().float()
    if t.numel() > 1 << 24:  # torch.quantile's limit; a seeded subsample
        g = torch.Generator(device=t.device).manual_seed(0)
        t = t[torch.randint(t.numel(), (1 << 24,), generator=g, device=t.device)]
    return [round(float(v), 4) for v in torch.quantile(t, torch.tensor(QUANTILES, device=t.device))]


@torch.no_grad()
def stats(cell, seed: int, device: str, pairs: int = 4) -> dict:
    cfg, mix = cell.config, cell.traffic
    sd = drawWeights(iconvsr.IconVSR(int(cfg["num_block"])).to("meta"), cfg["weights"], seed, device,
                     DTYPES[cfg["dtype"]])
    model = iconvsr.IconVSR(int(cfg["num_block"]))
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    model = model.to(device).eval()
    h, w = int(mix["height"]), int(mix["width"])
    frames = traffic.makeClip(mix, seed, device)
    x = iconvsr.alignPad(torch.cat([frameFromBytes(f, h, w, device) for f in frames]))
    offsets = {}

    def record(name):
        def hook(mod, args, out):
            offsets[name] = percentiles(out[:, : 2 * iconvsr.DG * 9].abs())

        return hook

    pcd = model.edvr.pcd_align
    for name, m in [(f"dcn_{lv}", pcd.dcn_pack[lv]) for lv in ("l3", "l2", "l1")] + [("dcn_cascade", pcd.cas_dcnpack)]:
        m.conv_offset.register_forward_hook(record(name))
    with fp32Exact():
        n = len(frames)
        model.edvr(x[iconvsr.edvrWindow(n // 2, n)][None])
        flows = torch.cat([model.spynet(x[t : t + 1], x[t + 1 : t + 2]) for t in range(pairs)])
    return {"offset_abs_px": offsets, "flow_abs_px": percentiles(flows.abs()), "quantiles": list(QUANTILES)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="offset and flow percentiles of an IconVSR cell's weights")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed, **stats(cell, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
