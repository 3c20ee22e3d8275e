"""muvo_tpu's parameter initialisation for the port's modules.

muvo_tpu builds its layers from flax: ``nn.Dense`` and ``nn.Conv`` draw
their kernels from ``lecun_normal`` (a normal truncated to two standard
deviations, scaled to variance 1 / fan_in) and start their biases at zero;
the norms start at scale 1, bias 0, running mean 0 and variance 1;
``nn.Embed`` draws N(0, 1 / features). A few parameters name their own
rule: the torch-geometry transposed convs draw U(+-sqrt(1 / fan_in)), the
decoders' learned constants N(0, 1), and so on. PyTorch's defaults differ
(kaiming_uniform(a=sqrt(5)) weights, U(+-1/sqrt(fan_in)) biases, torch's
fan-in of a ConvTranspose2d taken from its output channels), so a model
that kept them would start training from other distributions.

Fan-in follows flax's convention on muvo_tpu's kernel shape: the product of
every axis but the last. That is ``in`` for a Dense, ``kh kw cin / groups``
for a conv and ``kh kw cin`` for a transposed conv.

``reference_init_`` walks a model and sets every parameter and buffer of
every submodule by its rule: a rule for the module's type below, or the
module's own ``reference_init(generator)`` for the tensors it declares
itself (each names its muvo_tpu counterpart). A module with tensors and no
rule raises, so no tensor keeps torch's draw. Every draw comes from one
explicit CPU ``torch.Generator`` in the order of ``named_modules`` and is
then copied to the tensor's device: the same seed gives the same model on
the card and on the host, and torch's global random state is not read.
The draws cannot equal muvo_tpu's bit for bit (JAX's threefry and torch's
generators differ); ``weights.state_dict_from_jax`` carries muvo_tpu's
own values across where that is needed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Set

import torch
from torch import nn

# the standard deviation of a standard normal truncated to (-2, 2), by
# which flax's truncated_normal variance scaling divides
TRUNCATED_STD = 0.87962566103423978

Rule = Callable[[nn.Module, torch.Generator], Dict[str, torch.Tensor]]


def lecun_normal(shape, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: variance_scaling(1, "fan_in",
    "truncated_normal"), a standard normal truncated to (-2, 2) times
    sqrt(1 / fan_in) / TRUNCATED_STD."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(math.sqrt(1.0 / fan_in) / TRUNCATED_STD)


def uniform_fan_in(shape, fan_in: int, generator: torch.Generator):
    """flax's variance_scaling(1/3, "fan_in", "uniform"):
    U(-sqrt(1 / fan_in), sqrt(1 / fan_in))."""
    bound = math.sqrt(1.0 / fan_in)
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def normal(shape, std: float, generator: torch.Generator):
    """flax's ``normal(std)`` (and variance_scaling's "normal")."""
    return torch.empty(shape).normal_(0.0, std, generator=generator)


def _dense_or_conv(m, gen):
    # flax nn.Dense / nn.Conv (lecun_normal, zero bias) and the kernels
    # muvo_tpu declares as lecun_normal with zero biases: muvo_tpu/models/
    # layers.py:31-64,309, backbones/resnet.py:33-77,
    # backbones/mobilevit.py:54-172, common.py:77-186, rssm.py:40-42,
    # 103-106, transformer.py:55-66, stylegan.py:81-160,240-304,416-422,
    # 550-574, world_model.py:80-167, pointpillars.py:137,
    # ops/conv3d_zband.py:292-331, rl/networks.py:31-101, rl/policy.py:33-42.
    # A (in..., cout) kernel's fan-in is weight[0].numel() in torch's
    # (cout, cin / groups, k...) layout.
    out = {"weight": lecun_normal(m.weight.shape, m.weight[0].numel(), gen)}
    if m.bias is not None:
        out["bias"] = torch.zeros(m.bias.shape)
    return out


def _transposed_conv(m, gen):
    # muvo_tpu/models/layers.py:92,128 (ConvTranspose2dTorch,
    # SubPixelConvTranspose2d): variance_scaling(1/3, "fan_in", "uniform")
    # on a (kh, kw, cin, cout) kernel, fan-in kh kw cin; torch's
    # (cin, cout, kh, kw) weight. Bias zeros.
    w = m.weight
    out = {"weight": uniform_fan_in(w.shape, w.shape[0] * w[0, 0].numel(),
                                    gen)}
    if m.bias is not None:
        out["bias"] = torch.zeros(m.bias.shape)
    return out


def _norm(m, gen):
    # flax nn.BatchNorm, nn.LayerNorm, nn.GroupNorm (scale ones, bias
    # zeros, running mean zeros, var ones) and muvo_tpu/models/
    # pointpillars.py:31-38 (MaskedBatchNorm, the same)
    out = {}
    for name, t in list(m.named_parameters(recurse=False)) + list(
            m.named_buffers(recurse=False)):
        one = name in ("weight", "running_var")
        out[name] = torch.full(t.shape, 1.0 if one else 0.0, dtype=t.dtype)
    return out


def _embedding(m, gen):
    # flax nn.Embed's default, variance_scaling(1, "fan_in", "normal",
    # out_axis=0) on (num_embeddings, features): N(0, 1 / features)
    # (muvo_tpu/models/common.py:158, CommandEncoder)
    w = m.weight
    return {"weight": normal(w.shape, math.sqrt(1.0 / w.shape[1]), gen)}


def _gru_cell(m, gen):
    # muvo_tpu/models/rssm.py:75-90: GRUCell's gates are two Denses, ih
    # (in -> 3 hidden) and hh (hidden -> 3 hidden), lecun_normal with zero
    # biases; nn.GRUCell stacks the same r, z, n rows
    return {"weight_ih": lecun_normal(m.weight_ih.shape, m.input_size, gen),
            "weight_hh": lecun_normal(m.weight_hh.shape, m.hidden_size, gen),
            "bias_ih": torch.zeros(m.bias_ih.shape),
            "bias_hh": torch.zeros(m.bias_hh.shape)}


# by type, the first that matches (a transposed conv is also a _ConvNd)
TYPE_RULES = (
    (nn.modules.conv._ConvTransposeNd, _transposed_conv),
    (nn.modules.conv._ConvNd, _dense_or_conv),
    (nn.Linear, _dense_or_conv),
    ((nn.modules.batchnorm._NormBase, nn.LayerNorm, nn.GroupNorm), _norm),
    (nn.Embedding, _embedding),
    (nn.GRUCell, _gru_cell),
)


def _rule_of(module: nn.Module) -> Optional[Rule]:
    """The module's own ``reference_init``, else the rule of its type."""
    own = getattr(module, "reference_init", None)
    if own is not None:
        return lambda m, gen: own(gen)
    for types, rule in TYPE_RULES:
        if isinstance(module, types):
            return rule
    return None


@torch.no_grad()
def reference_init_(model: nn.Module, generator: torch.Generator) -> Set[str]:
    """Sets every parameter and buffer of ``model`` from muvo_tpu's
    initialisers, drawing from ``generator`` (a CPU generator), and
    returns the names it set. Raises for a module that holds tensors and
    has no rule."""
    done: Set[str] = set()
    for prefix, module in model.named_modules():
        own = dict(module.named_parameters(recurse=False))
        own.update(module.named_buffers(recurse=False))
        if not own:
            continue
        rule = _rule_of(module)
        if rule is None:
            raise TypeError(f"no initialiser for {prefix or 'the model'} "
                            f"({type(module).__name__}: {sorted(own)})")
        values = rule(module, generator)
        if set(values) != set(own):
            raise KeyError(f"{prefix}: the rule sets {sorted(values)}, the "
                           f"module holds {sorted(own)}")
        for name, value in values.items():
            own[name].copy_(value)
            done.add(f"{prefix}.{name}" if prefix else name)
    return done


def build(factory: Callable[[], nn.Module], seed: int,
          device="cpu") -> nn.Module:
    """``factory()``'s model on ``device``, initialised by reference_init_
    from a CPU generator seeded ``seed``: the same values on every device.
    The model is built on the meta device, so torch draws none of its own
    initial values."""
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device=device)
    reference_init_(model, torch.Generator().manual_seed(int(seed)))
    return model
