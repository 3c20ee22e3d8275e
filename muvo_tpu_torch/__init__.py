"""muvo_tpu_torch: the PyTorch/CUDA port of muvo_tpu.

The package mirrors muvo_tpu's module layout (config, data, models, ops,
inference) so each piece sits beside its JAX counterpart's name. It imports
torch and numpy only. Tensors cross module boundaries channels-last (NHWC,
NDHWC), as in muvo_tpu; parameter names are upstream MUVO's state_dict keys.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on CPU
tensors every hand-written kernel falls back to its plain PyTorch version.
"""

from muvo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
