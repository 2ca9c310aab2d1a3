"""Application entry of the PyTorch/CUDA port: compute worker process +
HTTP frontend.

Two processes connected by three pipes, a stop event and a shared
memory block for image payloads.  The worker is spawned, never forked,
and is the only process that touches CUDA, so the HTTP process stays
responsive while models load.

Usage: ``python3 app_torch.py [-g]``  (-g binds 0.0.0.0), from a directory
whose ``.user/config.json`` holds the settings, as for ``app.py``.
Set ``"device": "cpu"`` there to run on the CPU on purpose; otherwise
the worker needs a CUDA card and raises without one.
"""

import functools
import multiprocessing as mp
import os
import sys
from multiprocessing.shared_memory import SharedMemory

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SHM_PREFIX = "SharedMemoryMoeTorch"
onWindows = sys.platform.startswith("win")


def shmName(pid: int) -> str:
    """The shared-memory block of the app whose server process is ``pid``:
    one block a launch, so two apps never share an image buffer."""
    return f"{SHM_PREFIX}-{pid}"


def routes():
    """The worker's route table.  Imports are deferred to here so the
    server process never pays for them; model imports are lazier still,
    inside genProcess."""
    from moephoto_tpu_torch.config import config
    from moephoto_tpu_torch.pipeline.steps import genProcess
    from moephoto_tpu_torch.progress import Node
    from moephoto_tpu_torch.runtime.context import context
    from moephoto_tpu_torch.runtime.worker import begin, enhance
    from moephoto_tpu_torch.video.engine import SR_vid

    imageRoot = Node({"op": "image"}, learn=0)

    def holdInterface(seconds):
        """Countdown task that keeps the worker busy (UI lock)."""
        import time

        node = begin(Node({}, 1, seconds, 0))
        node.reset().trace(0)
        while seconds > 0 and not context.stopFlag.is_set():
            seconds -= 1
            time.sleep(1)
            node.trace()
        return seconds

    def runImageTask(size, *steps):
        """Compile the step chain and run it on the shared-memory image."""
        last = steps[-1] if steps and isinstance(steps[-1], dict) else {}
        name = last.get("file")  # taken before the op gate
        output = last if last.get("op") == "output" else {}
        bench = output.get("diagnose", {}).get("bench", False)
        process, nodes = genProcess([{"op": "file"}, *steps])
        tracked = begin(imageRoot, nodes, output.get("trace", False) or bench, bench)
        return tracked.bindFunc(process)(size, name=name)

    return {
        "lockInterface": holdInterface,
        "image_enhance": enhance(runImageTask, verbose=False),
        "batch": enhance(runImageTask, verbose=False),
        "video_enhance": enhance(SR_vid),
        "systemInfo": enhance(config.system),
    }


def main(name):
    """Worker-side bootstrap: attaches the server's shared-memory block
    ``name`` and returns (sharedMemory, route table).  Raises when the
    config asks for CUDA and there is none."""
    from moephoto_tpu_torch.config import config

    config.torchDevice()
    return SharedMemory(name), routes()


def launch():
    mp.set_start_method("spawn")
    from moephoto_tpu_torch.runtime.server import config as serverConfig, runserver
    from moephoto_tpu_torch.runtime.worker import worker

    name = shmName(os.getpid())
    shm = SharedMemory(name, True, serverConfig["sharedMemSize"])  # bound here: GC of the wrapper closes the mmap
    try:
        taskRx, taskTx = mp.Pipe(False)
        resultRx, resultTx = mp.Pipe(False)
        noteRx, noteTx = mp.Pipe(False)
        stop = mp.Event()
        mp.Process(
            target=worker,
            args=(functools.partial(main, name), taskRx, resultTx, noteTx, stop, onWindows),
            daemon=True,
        ).start()
        serve = runserver(taskTx, resultRx, noteRx, stop, shm, onWindows)
        host = "0.0.0.0" if "-g" in sys.argv[1:] else "127.0.0.1"
        serve(host, serverConfig["port"])
    finally:
        shm.unlink()


if __name__ == "__main__":
    launch()
