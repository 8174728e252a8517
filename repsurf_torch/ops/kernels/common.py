"""What every kernel wrapper checks and passes before it launches."""

import torch


def forward_only(*tensors):
    """For a kernel whose outputs are indices (FPS): refuse, rather than
    silently cut, a graph that would need a gradient through it."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise NotImplementedError(
            "this kernel returns indices and has no backward: pass coordinates "
            "that do not require grad (detach them)"
        )


def cuda_f32(t, name, shape):
    """Check a float32 CUDA input against ``shape`` (None = any size) and
    return it contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.ndim != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    return t.contiguous()


def counts_i32(valid, batch, device):
    """[B] valid counts as contiguous int32 on ``device``, or None."""
    if valid is None:
        return None
    if valid.shape != (batch,):
        raise ValueError(f"valid: expected shape ({batch},), got {tuple(valid.shape)}")
    return valid.to(device=device, dtype=torch.int32).contiguous()


def ptr(t):
    """Device pointer of a tensor, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(status, name):
    """Raise if the C entry returned a CUDA error code (a refused launch
    never runs, and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
