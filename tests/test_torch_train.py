"""The port's training path (moephoto_tpu_torch/parallel/sharded.py
``makeShardedLoss``, ``makeShardedTrainStep``, ``makeOptaxTrainStep``;
moephoto_tpu_torch/tools/train.py) against the JAX package's
(``parallel/sharded.py``, ``tools/train.py``): the port on ``cpu`` x n
meshes, JAX on its 8 virtual host devices at precision ``highest``.

Tolerances, fp32: the loss within 1e-6 relative, each parameter's gradient
within 1e-4 of its largest |g|, and an updated weight within lr times that
plus two fp32 spacings of the weight (one rounding of p - lr g in each
package).  A bias gradient is a sum over every pixel of the batch (2^15 to
2^17 terms) that the two packages add in other orders: the worst measured
is 3.9e-5 of max |g| (the up stages' biases on [1, 1]), the conv weights
stay under 1.2e-5.

The JAX steps update every shard with shard (0, 0)'s own gradient (the
transpose of ``psum`` under ``check_vma=False`` hands each shard a
cotangent of 1 on its own loss; ``out_specs=P()`` keeps shard (0, 0)'s
result), not the gradient of the loss they report.  The port takes the
gradient of the reported loss, the mean of the shards' gradients;
``test_sharded_step_takes_the_mean_gradient_where_jax_takes_shard_00``
holds both, so it fails the day the reference changes (ROADMAP Queue C).
"""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from moephoto_tpu_torch.models.api import fromJaxParams
from moephoto_tpu_torch.models.sr import MoeNetLite2
from moephoto_tpu_torch.parallel import sharded as S
from moephoto_tpu_torch.parallel.mesh import makeMesh
from moephoto_tpu_torch.synth import synthLite2Params
from moephoto_tpu_torch.tools import train as T
from tests.torch_one_thread import oneTorchThread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

HALO, SCALE, LR = 8, 2, 1e-3
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-4


def _jaxDevices(n):
    import jax

    devs = jax.devices("cpu")
    assert len(devs) >= 8, "tests/conftest.py forces 8 host devices"
    return devs[:n]


def _jaxParams():
    import __graft_entry__ as GE

    return GE._lite2Params(2, seed=0)


def _batch(seed=0, B=4, H=4 * 32, W=64):
    """The inputs of ``tests/test_parallel.py``'s sharded train step."""
    rng = np.random.RandomState(seed)
    return (rng.rand(B, H, W, 1).astype(np.float32), rng.rand(B, H * SCALE, W * SCALE, 1).astype(np.float32))


def _portMesh(shape):
    return makeMesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _jaxMesh(shape):
    from moephoto_tpu.parallel.mesh import makeMesh as jaxMakeMesh

    return jaxMakeMesh(shape, ("dp", "sp"), _jaxDevices(int(np.prod(shape))))


def _put(mesh, *arrays):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("dp", "sp", None, None))
    return [jax.device_put(a, sh) for a in arrays]


def _toTorch(params):
    """A JAX params tree (HWIO) as a torch-layout state dict."""
    return fromJaxParams({k: np.asarray(v) for k, v in params.items()})


def _portGrads(shape, x, y):
    """The port's loss and gradient on the ``cpu`` mesh of ``shape``."""
    lossOf = S.makeShardedLoss(MoeNetLite2(2, fused=False), _portMesh(shape), HALO, SCALE)
    masters = {k: v.requires_grad_() for k, v in synthLite2Params(2, 0).items()}
    loss = lossOf(masters, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(masters.values()))
    return float(loss.detach()), dict(zip(masters, grads))


def _shardGrads(params, x, y, dp, sp):
    """jax.grad of each shard's own loss: the shard's rows reflect-padded
    past the global edges and taken from its neighbours inside (numpy), the
    JAX model on them, ``HALO * SCALE`` rows cropped, mean |pred - y|.
    Returns {(i, j): (loss, torch-layout grads)}."""
    import jax
    import jax.numpy as jnp

    from moephoto_tpu.models.sr import moeNetLite2x2

    def localLoss(p, xp, ys):
        pred = moeNetLite2x2(p, xp)[:, HALO * SCALE : -HALO * SCALE]
        return jnp.mean(jnp.abs(pred - ys))

    vg = jax.jit(jax.value_and_grad(localLoss))
    padded = np.pad(x, ((0, 0), (HALO, HALO), (0, 0), (0, 0)), mode="reflect")
    per, h = x.shape[0] // dp, x.shape[1] // sp
    out = {}
    for i in range(dp):
        for j in range(sp):
            xp = padded[i * per : (i + 1) * per, j * h : (j + 1) * h + 2 * HALO]
            ys = y[i * per : (i + 1) * per, j * h * SCALE : (j + 1) * h * SCALE]
            loss, g = vg(params, jnp.asarray(xp), jnp.asarray(ys))
            out[i, j] = (float(loss), {k: v.double() for k, v in _toTorch(g).items()})
    return out


def _assertGrads(got, want, what):
    for k in want:
        gmax = float(want[k].abs().max())
        err = float((got[k].double() - want[k].double()).abs().max())
        assert err <= GRAD_TOL * gmax, f"{what} {k}: {err} against max |g| {gmax}"


def _assertUpdate(new, old, grads, lr, what, differ=None):
    """new == old - lr g within lr * GRAD_TOL * max|g| plus two fp32
    spacings of the larger of the old and new weight (one rounding of
    p - lr g in each package); with ``differ`` (grads too), also that it
    is more than 100 times that tolerance from old - lr differ."""
    for k, g in grads.items():
        want = old[k].double() - lr * g
        spacing = np.spacing(np.maximum(old[k].abs().numpy(), want.abs().numpy()).astype(np.float32))
        tol = lr * GRAD_TOL * float(g.abs().max()) + 2 * spacing.astype(np.float64)
        err = (new[k].double() - want).abs().numpy()
        assert np.all(err <= tol), f"{what} {k}: {float(err.max())}"
        if differ is not None and k == "convt_F11.conv_1.weight":
            far = float((new[k].double() - (old[k].double() - lr * differ[k])).abs().max())
            assert far > 100 * float(tol.max()), f"{what} {k}: the two gradients are {far} apart"


def test_sgd_step_on_one_shard_equals_jax():
    """One ``makeShardedTrainStep`` of lite x2 on a [1, 1] mesh at the
    shapes of ``tests/test_parallel.py`` (lr 1e-3): the loss, the gradient
    (jax.grad of the reflect-padded batch's loss) and the updated weights
    equal JAX's step's."""
    from moephoto_tpu.models.sr import moeNetLite2x2
    from moephoto_tpu.parallel.sharded import makeShardedTrainStep

    params = _jaxParams()
    x, y = _batch()
    mesh = _jaxMesh([1, 1])
    with mesh:
        jaxNew, jaxLoss = makeShardedTrainStep(moeNetLite2x2, mesh, halo=HALO, scale=SCALE, lr=LR)(
            params, *_put(mesh, x, y))
    jaxNew, jaxLoss = _toTorch(jaxNew), float(jaxLoss)
    ((_, want),) = _shardGrads(params, x, y, 1, 1).values()

    sd = synthLite2Params(2, 0)
    assert all(torch.equal(sd[k], v) for k, v in _toTorch(params).items())  # one draw in both packages
    loss, grads = _portGrads([1, 1], x, y)
    new, stepLoss = S.makeShardedTrainStep(MoeNetLite2(2, fused=False), _portMesh([1, 1]), HALO, SCALE, LR)(
        sd, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(loss - jaxLoss) <= LOSS_RTOL * jaxLoss and float(stepLoss) == loss
    _assertGrads(grads, want, "[1, 1]")
    _assertUpdate(new, sd, want, LR, "port [1, 1]")
    _assertUpdate(jaxNew, sd, want, LR, "jax [1, 1]")
    assert all(v.dtype == torch.float32 for v in new.values())


def test_sharded_step_takes_the_mean_gradient_where_jax_takes_shard_00():
    """On [2, 4]: the port's loss equals JAX's and the mean of the eight
    shards' own losses; its gradient and its SGD update are those of that
    mean, the mean of the eight per-shard JAX gradients.  JAX's step
    applies shard (0, 0)'s gradient: pinned here, the fault of the
    reference in ROADMAP Queue C.  Both steps at lr 1, as the measurement
    behind that entry, so that an update gives its gradient back to a few
    fp32 spacings and the two gradients lie far apart."""
    from moephoto_tpu.models.sr import moeNetLite2x2
    from moephoto_tpu.parallel.sharded import makeShardedTrainStep

    params = _jaxParams()
    x, y = _batch()
    mesh = _jaxMesh([2, 4])
    with mesh:
        jaxNew, jaxLoss = makeShardedTrainStep(moeNetLite2x2, mesh, halo=HALO, scale=SCALE, lr=1.0)(
            params, *_put(mesh, x, y))
    jaxNew, jaxLoss = _toTorch(jaxNew), float(jaxLoss)
    shards = _shardGrads(params, x, y, 2, 4)
    mean = {k: sum(g[k] for _, g in shards.values()) / len(shards) for k in shards[0, 0][1]}
    meanLoss = sum(l for l, _ in shards.values()) / len(shards)

    sd = synthLite2Params(2, 0)
    loss, grads = _portGrads([2, 4], x, y)
    new, _ = S.makeShardedTrainStep(MoeNetLite2(2, fused=False), _portMesh([2, 4]), HALO, SCALE, 1.0)(
        sd, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(loss - jaxLoss) <= LOSS_RTOL * jaxLoss and abs(loss - meanLoss) <= LOSS_RTOL * meanLoss
    _assertGrads(grads, mean, "port [2, 4] against the mean of the shards")
    _assertUpdate(new, sd, mean, 1.0, "port [2, 4]", differ=shards[0, 0][1])
    # the reference's behaviour: shard (0, 0)'s own gradient, not the mean
    _assertUpdate(jaxNew, sd, shards[0, 0][1], 1.0, "jax [2, 4] against shard (0, 0)", differ=mean)


def _jaxAdamState(optState):
    adam = optState[0]
    return int(adam.count), _toTorch(adam.mu), _toTorch(adam.nu)


def test_three_adam_steps_match_optax():
    """Three ``makeOptaxTrainStep`` steps with ``torch.optim.Adam`` (lr
    1e-3, betas (0.9, 0.999), eps 1e-8) against JAX's with ``optax.adam``
    on [1, 1], one batch a step, compared after every step.

    - The first and second moments: after the first step within GRAD_TOL
      of their largest entry (they are 0.1 g and 0.001 g^2); after the
      second and third within 1e-3 (measured 4.2e-4), because the weights
      they were taken at differ by up to 0.016 lr in the entries left out
      below, and the next gradients see those weights.
    - The weights: within 3e-4 lr after the first step, 1e-2 lr after the
      later ones (measured 1.2e-4, 3.4e-4 and 2.5e-3): from the second step
      on, m / sqrt(v) divides a sum of gradients that may nearly cancel, so
      the two packages' gradient differences grow in the update.  Adam's
      first step is about lr sign(g) but turns on eps where |g| is tiny, so
      an entry whose first gradient is under 1e-6 in magnitude may move
      otherwise in the other package: those entries are left out (and held
      within 6 lr, three full steps the other way)."""
    import optax

    from moephoto_tpu.models.sr import moeNetLite2x2
    from moephoto_tpu.parallel.sharded import makeOptaxTrainStep

    params = _jaxParams()
    batches = [_batch(seed, B=2, H=48, W=32) for seed in range(3)]
    mesh = _jaxMesh([1, 1])
    tx = optax.adam(LR)
    step = makeOptaxTrainStep(moeNetLite2x2, mesh, tx, halo=HALO, scale=SCALE)
    jp, state = params, tx.init(params)

    sd = synthLite2Params(2, 0)
    _, g0 = _portGrads([1, 1], *batches[0])
    masters = {k: v.clone().requires_grad_() for k, v in sd.items()}
    opt = torch.optim.Adam(masters.values(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    pstep = S.makeOptaxTrainStep(MoeNetLite2(2, fused=False), _portMesh([1, 1]), opt, HALO, SCALE)
    for n, (x, y) in enumerate(batches, 1):
        with mesh:
            jp, state, _ = step(jp, state, *_put(mesh, x, y))
        pstep(masters, torch.from_numpy(x), torch.from_numpy(y))
        count, mu, nu = _jaxAdamState(state)
        want = _toTorch(jp)
        assert count == n
        for k, p in masters.items():
            st = opt.state[p]
            assert int(st["step"]) == n
            for name, got, ref in (("mu", st["exp_avg"], mu[k]), ("nu", st["exp_avg_sq"], nu[k])):
                err = float((got - ref).abs().max())
                assert err <= (GRAD_TOL if n == 1 else 1e-3) * float(ref.abs().max()), f"step {n} {name} {k}: {err}"
            err = (p.detach() - want[k]).abs()
            kept = err[g0[k].abs() >= 1e-6]
            tol = (3e-4 if n == 1 else 1e-2) * LR
            assert kept.numel() == 0 or float(kept.max()) <= tol, f"step {n} {k}: {float(kept.max())}"
            assert float(err.max()) <= 6 * LR, k


# The parameters whose gradient JAX's bf16 step takes as the port's does:
# the im path's up stage and the two heads read conv_input's output and
# the loss's cotangent through products that keep fp32 outputs in both
# packages, so the two bf16 steps round at the same points there.
UP_PATH = ("uim.0.0.weight", "uim.0.0.bias", "convt_R1.weight", "convt_I1.weight")
BF16_TOL = 3e-3


def _relL2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _portAdamStep(x, y, computeDtype):
    """One ``makeOptaxTrainStep`` with Adam (lr LR) on [1, 1] from the
    seeded masters: (loss, masters, first moments, second moments)."""
    sd = synthLite2Params(2, 0)
    masters = {k: v.clone().requires_grad_() for k, v in sd.items()}
    opt = torch.optim.Adam(masters.values(), lr=LR)
    step = S.makeOptaxTrainStep(MoeNetLite2(2, fused=False), _portMesh([1, 1]), opt, HALO, SCALE,
                                computeDtype=computeDtype)
    _, loss = step(masters, torch.from_numpy(x), torch.from_numpy(y))
    for k, p in masters.items():
        st = opt.state[p]
        assert p.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32, k
    mu = {k: opt.state[p]["exp_avg"] for k, p in masters.items()}
    nu = {k: opt.state[p]["exp_avg_sq"] for k, p in masters.items()}
    return loss, {k: p.detach() for k, p in masters.items()}, mu, nu


def test_bf16_step_keeps_fp32_masters_and_matches_jax():
    """One ``computeDtype=torch.bfloat16`` Adam step against JAX's bf16
    ``makeOptaxTrainStep`` (``optax.adam``, same masters, same batch) on
    [1, 1]: on a larger mesh JAX applies shard (0, 0)'s gradient, which
    would hide the comparison.  The masters and Adam's state stay fp32.

    - The loss within 1e-3 relative of JAX's (measured 2.7e-4).
    - On ``UP_PATH`` the first moment (0.1 g) within BF16_TOL relative L2
      of JAX's (measured 1.3e-3 at most), the second within 2 BF16_TOL
      (measured 2.6e-3), and the updated masters within 1e-4 lr of JAX's
      (measured 4.1e-5 lr), entries whose |g| is under 1e-6 left out, as
      in the Adam test, and held within 2 lr.  The port's fp32 step lies
      further than BF16_TOL from JAX's bf16 one on each of these (measured
      4.5e-3 to 4.4e-2): a step that stayed in fp32 fails here.
    - Everywhere else JAX's bf16 gradient is 20 % to 300 % from its own
      fp32 one (the FRM and PReLU parameters: its backward reduces in
      bf16), so there the port's bf16 first moment is held within 0.25
      relative L2 of the port's fp32 one (measured 0.16 at most, a PReLU
      slope; 1.4e-2 over all parameters): a wrong bf16 backward is not."""
    import jax.numpy as jnp
    import optax

    from moephoto_tpu.models.sr import moeNetLite2x2
    from moephoto_tpu.parallel.sharded import makeOptaxTrainStep

    params = _jaxParams()
    x, y = _batch(B=2, H=64)
    mesh = _jaxMesh([1, 1])
    tx = optax.adam(LR)
    step = makeOptaxTrainStep(moeNetLite2x2, mesh, tx, halo=HALO, scale=SCALE, computeDtype=jnp.bfloat16)
    with mesh:
        jp, state, jaxLoss = step(params, tx.init(params), *_put(mesh, x, y))
    jaxLoss, want = float(jaxLoss), _toTorch(jp)
    _, mu, nu = _jaxAdamState(state)

    loss, masters, pmu, pnu = _portAdamStep(x, y, torch.bfloat16)
    _, _, fmu, _ = _portAdamStep(x, y, None)
    assert loss.dtype == torch.float32 and abs(float(loss) - jaxLoss) <= 1e-3 * jaxLoss, (float(loss), jaxLoss)
    sd = synthLite2Params(2, 0)
    assert not torch.equal(masters["convt_F11.conv_1.weight"], sd["convt_F11.conv_1.weight"])
    for k in UP_PATH:
        assert _relL2(pmu[k], mu[k]) <= BF16_TOL, (k, _relL2(pmu[k], mu[k]))
        assert _relL2(pnu[k], nu[k]) <= 2 * BF16_TOL, (k, _relL2(pnu[k], nu[k]))
        assert _relL2(fmu[k], mu[k]) > BF16_TOL, (k, "the fp32 step is as close", _relL2(fmu[k], mu[k]))
        err = (masters[k] - want[k]).abs()
        kept = err[(mu[k] / 0.1).abs() >= 1e-6]
        assert kept.numel() == 0 or float(kept.max()) <= 1e-4 * LR, (k, float(kept.max()))
        assert float(err.max()) <= 2 * LR, k
    for k in pmu:
        assert _relL2(pmu[k], fmu[k]) <= 0.25, (k, _relL2(pmu[k], fmu[k]))


def test_patch_sampler_draws_jax_patches(tmp_path):
    """For a seed the port's ``PatchSampler`` gives the JAX package's
    patches, bit for bit: luma x2, luma x1 with noise, RGB x2."""
    import train as jaxTrain

    paths = _writeImages(str(tmp_path), n=3, size=96)
    for scale, channels in ((2, 1), (1, 1), (2, 3)):
        a = T.PatchSampler(paths, 24, scale, seed=5, channels=channels, sigma=0.05)
        b = jaxTrain.PatchSampler(paths, 24, scale, seed=5, channels=channels, sigma=0.05)
        for _ in range(2):
            for got, want in zip(a.batch(3), b.batch(3)):
                np.testing.assert_array_equal(got, want)


# --- the CLI: counterparts of tests/test_train.py --------------------------------


def _writeImages(d, n=2, size=96):
    """``tests/test_train.py``'s synthetic structured images."""
    from PIL import Image

    rng = np.random.RandomState(7)
    paths = []
    for i in range(n):
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        im = 0.5 + 0.3 * np.sin(8 * yy + i) * np.cos(6 * xx) + 0.1 * rng.rand(size, size)
        p = os.path.join(d, f"im{i}.png")
        Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        params = T.main(argv)
    return params, buf.getvalue()


def test_train_cli_descends_and_resumes(tmp_path):
    """``tests/test_train.py::test_train_cli_descends_and_resumes`` on the
    port: --mesh 2,4 --backend cpu; a short run writes a checkpoint, and
    resuming continues from its step, moves the weights and ends below the
    first step's loss (the JAX test holds a fresh 12-step run to that)."""
    data = str(tmp_path / "*.png")
    _writeImages(str(tmp_path))
    out = str(tmp_path / "ckpt")
    argv = ["--data", data, "--model", "lite", "--scale", "2", "--batch", "4", "--patch", "48", "--lr", "3e-4",
            "--mesh", "2,4", "--backend", "cpu", "--out", out, "--saveEvery", "100", "--seed", "3", "--fromScratch"]
    p1, text = _run(argv + ["--steps", "4"])
    assert os.path.isdir(os.path.join(out, "state"))
    lines = text.splitlines()
    assert lines[0].startswith("step 1/4 loss ") and "done: 4 steps, final loss " in text
    first = float(lines[0].rsplit(" ", 1)[1])
    p2, text = _run(argv + ["--steps", "8", "--resume"])
    lines = text.splitlines()
    assert lines[0] == "resumed from step 4" and lines[1].startswith("step 5/8 loss ")
    assert any(not torch.allclose(a, p2[k]) for k, a in p1.items()), "resume made no progress"
    state = torch.load(os.path.join(out, "state", "train.pt"), weights_only=True)
    assert state["step"] == 8 and state["optState"]["state"][0]["step"] == 8
    assert lines[-1].startswith("done: 8 steps, final loss ")
    final = float(lines[-1].rsplit(" ", 1)[1])
    assert final < first, (first, final)


def test_trained_params_drop_into_inference(tmp_path):
    """The CLI's state dict loads into the inference ``MoeNetLite2(2)``
    with ``strict=True``; on a module whose fused weights were prepared
    before the load, the fused path (its plain version on the CPU) equals
    the unfused path on the trained weights: the prepared weights were
    built anew."""
    _writeImages(str(tmp_path))
    params, _ = _run(["--data", str(tmp_path / "*.png"), "--model", "lite", "--scale", "2", "--batch", "2",
                      "--patch", "32", "--steps", "2", "--mesh", "1,1", "--backend", "cpu",
                      "--out", str(tmp_path / "ck")])
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in params.values())
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 24, 24, 1).astype(np.float32))
    model = MoeNetLite2(2).eval()
    model.load_state_dict(synthLite2Params(2, 0), strict=True)
    with torch.inference_mode():
        before = model(x)
    assert len(model._upCache) == 1
    model.load_state_dict(params, strict=True)
    with torch.inference_mode():
        fused = model(x)
        model.fused = False
        plain = model(x)
    assert fused.shape == (1, 48, 48, 1) and torch.isfinite(fused).all()
    torch.testing.assert_close(fused, plain, atol=1e-6, rtol=1e-5)
    assert float((fused - before).abs().max()) > 1e-4  # the trained weights, not the prepared old ones


def test_train_improves_heldout_psnr_bf16(tmp_path):
    """``tests/test_train.py::test_train_improves_heldout_psnr_bf16`` on the
    port: lite x2 from scratch, --computeDtype bf16 on --mesh 2,2, 20
    steps at lr 3e-3 (from scratch the gain is far above the gate: +20 dB
    measured); the held-out PSNR gains at least 3 dB and the masters stay
    fp32."""
    from PIL import Image

    _writeImages(str(tmp_path), n=3, size=96)
    holdDir = tmp_path / "holdout"
    os.makedirs(str(holdDir))
    size = 96
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    im = 0.5 + 0.3 * np.sin(8 * yy + 0.7) * np.cos(6 * xx + 0.3)
    Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(str(holdDir / "h.png"))

    model, params0, halo, scale, channels = T.buildModel("lite", 2, fromScratch=True)
    sampler = T.PatchSampler([str(holdDir / "h.png")], 32, scale, channels=channels)
    before = T.evalPSNR(model, params0, sampler)
    params, text = _run(["--data", str(tmp_path / "*.png"), "--model", "lite", "--scale", "2", "--batch", "4",
                         "--patch", "32", "--steps", "20", "--lr", "3e-3", "--mesh", "2,2", "--backend", "cpu",
                         "--out", str(tmp_path / "q"), "--fromScratch", "--computeDtype", "bf16",
                         "--holdout", str(holdDir / "*.png")])
    assert all(v.dtype == torch.float32 for v in params.values())
    assert "held-out PSNR before: " in text and "held-out PSNR after: " in text
    after = T.evalPSNR(model, params, sampler)
    assert after >= before + 3.0, (before, after)


def test_registry_model_without_its_checkpoint_stops_as_jax(tmp_path, monkeypatch):
    """A registry model whose checkpoint is missing stops with the JAX
    CLI's message; an unknown name too."""
    import train as jaxTrain

    from moephoto_tpu.config import config as jaxConfig
    from moephoto_tpu_torch.config import config

    monkeypatch.setattr(config, "modelDir", str(tmp_path))
    monkeypatch.setattr(jaxConfig, "modelDir", str(tmp_path))
    monkeypatch.delenv("MOEPHOTO_REFERENCE_ROOT", raising=False)
    for name in ("lite5", "nope"):
        with pytest.raises(SystemExit) as got:
            T.buildModel(name, 1)
        with pytest.raises(SystemExit) as want:
            jaxTrain.buildModel(name, 1, None)
        assert str(got.value) == str(want.value), name


def test_cli_devices_stop_as_jax(tmp_path, monkeypatch):
    """Without a card the CLI stops unless --backend cpu says the CPU; on
    the cards a mesh larger than their count stops with the JAX CLI's
    message (one card simulated); an unknown backend stops."""
    argv = ["--data", str(tmp_path / "*.png"), "--out", str(tmp_path / "o")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device; pass --backend cpu"):
        T.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"^mesh 2x2 needs 4 devices, have 1$"):
        T.main(argv + ["--mesh", "2,2"])
    with pytest.raises(SystemExit, match="unknown --backend tpu"):
        T.main(argv + ["--backend", "tpu"])


def test_train_registry_denoise_model(tmp_path):
    """``tests/test_train.py::test_train_registry_denoise_model`` on the
    port: fine-tune dn lite5 from its real checkpoint (noise degradation
    at scale 1); skips where the JAX test skips, without the checkpoint
    mount."""
    from tests.conftest import hasReference

    if not hasReference():
        pytest.skip("needs the reference checkpoint mount")
    _writeImages(str(tmp_path))
    params, _ = _run(["--data", str(tmp_path / "*.png"), "--model", "lite5", "--batch", "2", "--patch", "32",
                      "--steps", "2", "--mesh", "2,2", "--backend", "cpu", "--out", str(tmp_path / "dn"),
                      "--sigma", "0.05"])
    assert os.path.isdir(str(tmp_path / "dn" / "state"))
    assert all(torch.isfinite(v).all() for v in params.values())
