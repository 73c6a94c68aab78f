"""The collectives of the SPMD iterations over a torch.distributed group.

What JAX's ``shard_map`` gives the parallel iterations for free: the
axis size and index, ``lax.ppermute`` and ``lax.psum``, and the gather
of an axis-sharded array.  `group` None is the default group.  The
group's backend decides the tensors' device: NCCL takes CUDA tensors,
gloo CPU tensors, and a tensor of the other kind raises (nothing is
staged through the host unasked).  NCCL calls order themselves against
the tensors' current stream, so no host synchronisation is needed
around them.
"""

import torch
import torch.distributed as dist

_DEVICE_OF_BACKEND = {"nccl": "cuda", "gloo": "cpu"}


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)


def _peer(group, r):
    return r if group is None else dist.get_global_rank(group, r)


def check_device(t, group=None):
    """Raise unless `t` lies on the device kind of the group's backend."""
    backend = str(dist.get_backend(group))
    want = _DEVICE_OF_BACKEND.get(backend)
    if want is not None and t.device.type != want:
        raise ValueError(f"a {t.device.type} tensor on a {backend} group: "
                         f"{backend} takes {want} tensors")


def exchange_into(messages, group=None):
    """Batched ppermutes: for each (x, k, into) of `messages`, every rank
    sends x to rank d+k and receives the matching tensor from rank d-k
    (mod the group size) into `into`, a contiguous tensor of x's shape
    (a leading-axis slice of a larger buffer, say).  A message to the
    rank itself is a local copy, as JAX's ppermute is."""
    D, d = axis_size(group), rank(group)
    ops = []
    for i, (x, k, into) in enumerate(messages):
        check_device(x, group)
        check_device(into, group)
        dst, src = (d + k) % D, (d - k) % D
        if dst == d:
            into.copy_(x)
            continue
        # distinct tags keep several messages between one pair apart on
        # gloo; NCCL matches them in the order they are posted
        ops += [dist.P2POp(dist.isend, x.contiguous(), _peer(group, dst),
                           group, tag=i),
                dist.P2POp(dist.irecv, into, _peer(group, src), group,
                           tag=i)]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()


def exchange(sends, group=None):
    """`exchange_into` with fresh tensors: for each (x, k) of `sends`, the
    tensor received from rank d-k, in the order of `sends`."""
    outs = [torch.empty_like(x, memory_format=torch.contiguous_format)
            for x, _ in sends]
    exchange_into([(x, k, o) for (x, k), o in zip(sends, outs)], group)
    return outs


def ppermute(x, k, group=None):
    """Send x to rank d+k, receive from rank d-k (JAX's ppermute with
    the pairs (d, d+k))."""
    return exchange([(x, k)], group)[0]


def psum(x, group=None):
    """The sum of x over the group's ranks (a new tensor)."""
    check_device(x, group)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x, group=None):
    """The ranks' x concatenated along axis 0 in rank order: the gather
    of an array sharded into contiguous blocks."""
    check_device(x, group)
    x = x.contiguous()
    out = torch.empty((axis_size(group) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:
        gather = dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


def any_rank(flag: bool, device, group=None) -> bool:
    """Whether `flag` holds on any rank (one all-reduce of an int)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return bool(int(t) > 0)
