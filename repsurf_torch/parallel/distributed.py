"""Process groups for data parallelism (repsurf_tpu/parallel/distributed.py)
over ``torch.distributed``.

The JAX package drives every device from one process; the port runs one
process a card, as the reference does (segmentation/tool/train.py:106-150):
``spawn`` starts them from one command, each calls ``init_distributed``
with its rank, and the group meets over loopback (``tcp://127.0.0.1``) or
a ``file://`` store, so it needs no network.  NCCL serves CUDA tensors,
gloo CPU tensors.  ``all_reduce_sum`` is the differentiable all-reduce of
the synchronised batch norm: its gradient is the all-reduce of the
cotangents, as JAX's ``psum`` transposes.
"""

import datetime
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port():
    """A TCP port on the loopback interface that was free just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(backend="gloo", world_size=1, rank=0, init_method=None, timeout_s=None):
    """Join the default process group (a no-op when it exists already).

    Args:
      backend: "nccl" for CUDA tensors, "gloo" for CPU tensors.
      world_size, rank: this process's place in the group.
      init_method: where the group meets, ``tcp://127.0.0.1:<port>`` or
        ``file://<path>``; a fresh loopback port when None (world size 1
        only: the other ranks could not know it).
      timeout_s: seconds a collective may wait before it fails (torch's
        default when None).
    """
    if dist.is_initialized():
        return
    if init_method is None:
        if world_size > 1:
            raise ValueError("a group of several processes needs a shared init_method")
        init_method = f"tcp://127.0.0.1:{free_port()}"
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            **kwargs)


def shutdown():
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info():
    """(rank, world size) of this process; (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main_process():
    """The rank-0 gate for logging and checkpoints (the reference's
    ``main_process``, segmentation/util/utils.py:16-22)."""
    return process_info()[0] == 0


def local_batch_size(global_batch_size):
    """Samples a rank steps (the reference's ``batch_size // world_size``,
    segmentation/tool/train.py:130-132)."""
    n = process_info()[1]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group=None):
    """The sum of ``x`` over the ranks of ``group`` (the default group when
    None); its gradient is the sum of the ranks' cotangents.  Every rank
    must call it in the same order."""
    return _AllReduceSum.apply(x, group)


def spawn(fn, world_size, args=(), timeout_s=None):
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (the
    ``spawn`` start method: ``fn`` and ``args`` must pickle) and wait for
    them.  A process that fails raises here; past ``timeout_s`` seconds
    every process is stopped and ``TimeoutError`` raised."""
    ctx = mp.start_processes(fn, args=args, nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} processes still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
