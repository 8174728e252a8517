"""Reference PyTorch checkpoints into the port (repsurf_tpu/train/torch_import.py
``load_torch_state_dict``, ``_conv_kernel``).

The reference saves {'model_state_dict': ...} (classification,
train_cls_scanobjectnn.py:261-271) or {'state_dict': ...} (segmentation,
tool/train.py:246-253), under DataParallel's / DDP's ``module.`` prefix, with
its shared MLPs as 1x1 convolutions ([O, I, 1] or [O, I, 1, 1] weights) and
a ``num_batches_tracked`` counter in every BatchNorm.  The port's modules
carry the reference's names (``nn/blocks.py``, ``nn/pointtransformer.py``),
so once those four differences are undone the state dict loads strictly:
``MaskedBatchNorm`` keeps no step counter, and the port's own ``best.pt``
files keep loading strictly.
"""

import torch


def reference_state_dict(payload):
    """The port's state dict from a loaded reference payload: the
    ``model_state_dict`` / ``state_dict`` entry when there is one, the
    ``module.`` prefix stripped, 1x1 convolution weights squeezed to
    [O, I], ``num_batches_tracked`` dropped.  Tensors are copied, so the
    result never aliases the payload."""
    for key in ("model_state_dict", "state_dict"):
        if key in payload:
            payload = payload[key]
            break
    out = {}
    for name, value in payload.items():
        name = name[len("module."):] if name.startswith("module.") else name
        if name.endswith("num_batches_tracked"):
            continue
        value = torch.as_tensor(value).detach().clone()
        while value.ndim > 2:
            if value.shape[-1] != 1:
                raise ValueError(f"{name}: {tuple(value.shape)} is not a 1x1 convolution")
            value = value[..., 0]
        out[name] = value
    return out


def load_reference_state_dict(path):
    """``reference_state_dict`` of a reference ``.pth`` file, on the CPU.

    A reference payload pickles numpy scalars (the accuracies) beside its
    tensors, which ``weights_only=True`` refuses; load only files you
    trust."""
    return reference_state_dict(torch.load(path, map_location="cpu", weights_only=False))


def load_reference_weights(model, path):
    """Load a reference ``.pth`` into ``model`` in place, strictly."""
    model.load_state_dict(load_reference_state_dict(path), strict=True)


def restore_any_weights(model, path):
    """The eval CLI's ``--model_path``: the port's own payload (a
    ``model`` entry beside its optimizer state, ``train/checkpoint.py``) or
    a reference file, told apart by the payload's keys.  Returns "port" or
    "reference"."""
    payload = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    if "model" in payload and "optimizer" in payload:
        model.load_state_dict(payload["model"], strict=True)
        return "port"
    model.load_state_dict(reference_state_dict(payload), strict=True)
    return "reference"
