"""Generic REPA: representation alignment against DINOv2 tokens for any
module of the denoiser.

Counterpart of ``yat_tpu/ops/repa.py``.  The JAX package records the
target modules' outputs with flax ``capture_intermediates``; the port
registers forward hooks for the length of one forward
(:func:`capture_features`).  A module matches a target when its name is
the target or its flax path (``/``-joined, ``blocks_7/attn1``) ends with
it.  Each output tensor of a matched module becomes token features: a 2-D
output gains a batch axis, a 4-D NHWC output flattens to tokens, other
ranks are dropped; the features come in the order of the JAX package's
tree leaves (sorted paths).  The hooks are removed when the forward ends,
so the recomputation of a block under remat (``torch.utils.checkpoint``
in the backward) captures nothing twice: the loss and its gradient equal
those of the step without remat.

The projection head (:class:`RepaMLP`, fc1 → SiLU → fc2 in fp32) lives
outside the denoiser: the trainer trains it beside the adapters (under
the reserved name ``repa_head``) or beside the full parameters, and the
quantized base never includes it.  The bundle (``repa_config.json`` and the
head in ``model.safetensors``) is the JAX package's layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yat_tpu_torch.models.layers import AdapterDense


@dataclasses.dataclass(frozen=True)
class RepaConfig:
    target_modules: Tuple[str, ...]
    target_shape: int = 768          # DINO ViT-B token width
    hidden_shape: int = 1024         # projection MLP hidden width


class RepaMLP(nn.Module):
    """The two-layer projection head, fp32 (flax ``nn.Dense`` fc1 and fc2:
    lecun-normal kernels, zero biases)."""

    def __init__(self, cfg: RepaConfig, feature_dim: int):
        super().__init__()
        self.fc1 = AdapterDense(feature_dim, cfg.hidden_shape,
                                dtype=torch.float32)
        self.fc2 = AdapterDense(cfg.hidden_shape, cfg.target_shape,
                                dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(x.float())))


def init_repa_head(cfg: RepaConfig, feature_dim: int, seed: int,
                   device="cpu") -> RepaMLP:
    """A :class:`RepaMLP` on ``device``, initialised from ``seed``."""
    from yat_tpu_torch.models.layers import init_params
    with torch.device(device):
        head = RepaMLP(cfg, feature_dim)
    init_params(head, torch.Generator(device=device).manual_seed(seed))
    return head


def _matching(model: nn.Module, targets: Sequence[str]
              ) -> List[Tuple[Tuple[str, ...], nn.Module]]:
    from yat_tpu_torch.adapters.builder import module_paths
    return [(path, m) for path, m in module_paths(model)
            if any(path[-1] == t or "/".join(path).endswith(t)
                   for t in targets)]


def _tokens(out) -> List[torch.Tensor]:
    leaves = list(out) if isinstance(out, (tuple, list)) else [out]
    feats = []
    for t in leaves:
        if not isinstance(t, torch.Tensor):
            continue
        if t.ndim == 2:
            t = t[None]
        elif t.ndim == 4:                     # NHWC conv features → tokens
            b, h, w, c = t.shape
            t = t.reshape(b, h * w, c)
        if t.ndim == 3:
            feats.append(t)
    return feats


@contextlib.contextmanager
def capture_features(model: nn.Module, cfg: RepaConfig
                     ) -> Iterator[List[torch.Tensor]]:
    """Inside the block, every forward of a target module appends its
    outputs (as ``[B, N, C]`` tokens) to the yielded list; after it, the
    list holds them in sorted path order and the hooks are gone.  Under
    ``sp`` (a model whose forward sliced its tokens) each output is
    gathered whole, as the JAX term sees the whole token grid."""
    records: List[Tuple[Tuple[str, ...], int, torch.Tensor]] = []
    feats: List[torch.Tensor] = []
    handles = []
    sp = getattr(model, "sequence_parallel", None)
    for path, m in _matching(model, cfg.target_modules):
        def hook(_mod, _args, out, _path=path):
            for t in _tokens(out):
                if sp is not None and sp.sharded:
                    t = sp.gather(t, t.shape[1] * sp.size)
                records.append((_path, len(records), t))
        handles.append(m.register_forward_hook(hook))
    try:
        yield feats
    finally:
        for h in handles:
            h.remove()
        feats.extend(t for _, _, t in sorted(records, key=lambda r: r[:2]))


def generic_repa_loss(feats: List[torch.Tensor], head: nn.Module,
                      dino_tokens: torch.Tensor) -> torch.Tensor:
    """The mean over the captured modules of the alignment term of each
    one's projection (0 when nothing was captured)."""
    from yat_tpu_torch.train.tasks import repa_alignment_loss
    if not feats:
        return torch.zeros((), device=dino_tokens.device)
    return torch.stack([repa_alignment_loss(head(f), dino_tokens)
                        for f in feats]).mean()


def save_repa_bundle(directory: str, cfg: RepaConfig, head: RepaMLP) -> None:
    """``repa_config.json`` + ``model.safetensors`` (the head under
    ``repa.``, flax layouts), as the JAX package writes them."""
    from yat_tpu_torch.train.checkpoint import save_params_only
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "repa_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    save_params_only(directory, {"repa": head_tree(head)})


def load_repa_bundle(directory: str, feature_dim: int,
                     device="cpu") -> Tuple[RepaConfig, RepaMLP]:
    """The bundle :func:`save_repa_bundle` (or the JAX package) wrote."""
    from yat_tpu_torch.convert import load_flax_params
    from yat_tpu_torch.train.checkpoint import load_params_only
    with open(os.path.join(directory, "repa_config.json")) as f:
        raw = json.load(f)
    cfg = RepaConfig(target_modules=tuple(raw["target_modules"]),
                     target_shape=int(raw["target_shape"]),
                     hidden_shape=int(raw["hidden_shape"]))
    head = init_repa_head(cfg, feature_dim, 0, device)
    like = {"repa": head_tree(head)}
    load_flax_params(head, load_params_only(directory, like)["repa"])
    return cfg, head


def head_tree(head: nn.Module) -> Dict:
    """The head's parameters as the JAX package's nested tree of fp32
    numpy arrays in the flax layouts (``{"fc1": {"kernel", "bias"},
    ...}``)."""
    from yat_tpu_torch.convert import flax_params
    tree: Dict = {}
    for path, t in flax_params(head).items():
        *keys, leaf = path.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree
