"""Start N ranks of a function, each a process with one device.

    from c2ray_tpu_torch.parallel.launch import launch
    results = launch(fn, 4, args=(...,))            # nccl, cuda:<rank>
    results = launch(fn, 8, args=(...,), device="cpu")   # gloo

Each rank runs ``fn(*args)`` inside an initialised default process
group (``torch.distributed``), NCCL on ``cuda:<rank>`` or gloo on the
CPU, and ``launch`` returns the ranks' return values in rank order
(they travel by pickle: return host values, numpy arrays or CPU
tensors).  The group meets through a ``FileStore`` in a fresh
temporary directory, so no TCP port is taken and parallel launches
cannot collide.  ``fn`` must be importable by name (a module-level
function) since the ranks are spawned processes.  ``torchrun`` does the
same for scripts; this is for callers without it, and for the tests.
"""

import os
import pickle
import shutil
import tempfile


def _rank_main(rank, fn, world, device, store_path, out_dir, args,
               threads):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    backend = "nccl" if device == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, args=(), device: str = "cuda",
           threads: int = 0):
    """Run fn(*args) on `n_ranks` ranks; returns their results in rank
    order.  `device` "cuda" takes NCCL and one card per rank, "cpu"
    gloo; `threads` > 0 sets each rank's torch thread count."""
    import torch.multiprocessing as mp

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda":
        import torch

        if torch.cuda.device_count() < n_ranks:
            raise RuntimeError(f"{n_ranks} ranks need {n_ranks} CUDA "
                               f"devices, found {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="c2ray_launch_")
    try:
        mp.spawn(_rank_main, args=(fn, n_ranks, device,
                                   os.path.join(tmp, "store"), tmp, args,
                                   threads),
                 nprocs=n_ranks, join=True)
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
