"""Production meshes of the port, the counterpart of ``repro.launch.mesh``.

``make_production_mesh`` is a function (never a module-level constant),
so importing this module touches no process group. Single-pod: 16×16 =
256 ranks ("data", "model"); multi-pod: 2×16×16 = 512 ranks ("pod",
"data", "model"), the pod axis an extra data-parallel dimension.

``init_local_group`` and ``run_local_ranks`` start the ranks of one host
with no network: a ``FileStore`` in a temporary directory, and a group
timeout of ``GROUP_TIMEOUT_S`` seconds.
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_mesh_shape", "GROUP_TIMEOUT_S", "init_local_group", "run_local_ranks"]


def make_mesh_shape(*, multi_pod: bool = False):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """A ``DeviceMesh`` of the production shape over the default process
    group, which must be initialised with at least as many ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = make_mesh_shape(multi_pod=multi_pod)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}: initialise the default "
            "process group with that many ranks first"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


#: every process group's timeout: a mismatched collective fails, not hangs
GROUP_TIMEOUT_S = 120


def init_local_group(rank: int, world: int, store_path: str, backend: str) -> None:
    """Initialise the default process group of ``world`` ranks on this host
    through a ``FileStore`` at ``store_path`` (no network), with
    ``GROUP_TIMEOUT_S``; ``backend`` is "nccl" on the card, "gloo" on the
    CPU."""
    import datetime

    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def run_local_ranks(code: str, world: int, *, timeout: float = 300, cwd=None, env=None) -> list:
    """Run ``python -c code`` as ``world`` ranks on this host, each with
    ``RANK``, ``WORLD_SIZE`` and ``REPRO_STORE`` (a ``FileStore`` path in a
    fresh temporary directory) in its environment; the code calls
    ``init_local_group``. Returns each rank's ``CompletedProcess`` (its
    output read from files, so no rank blocks on a full pipe); ranks still
    running ``timeout`` seconds after the start are killed."""
    import os
    import subprocess
    import sys
    import tempfile
    import time

    with tempfile.TemporaryDirectory() as tmp:
        procs, files = [], []
        for rank in range(world):
            e = dict(os.environ if env is None else env, RANK=str(rank), WORLD_SIZE=str(world),
                     REPRO_STORE=os.path.join(tmp, "store"))
            f = (open(os.path.join(tmp, f"{rank}.out"), "w+"), open(os.path.join(tmp, f"{rank}.err"), "w+"))
            files.append(f)
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=e, text=True,
                                          stdout=f[0], stderr=f[1]))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = []
        for p, (fo, fe) in zip(procs, files):
            fo.seek(0)
            fe.seek(0)
            out.append(subprocess.CompletedProcess(p.args, p.returncode, fo.read(), fe.read()))
            fo.close()
            fe.close()
        return out
