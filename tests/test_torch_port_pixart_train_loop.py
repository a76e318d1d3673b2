"""PyTorch port, the rest of the training loop for PixArt-Sigma on the CPU,
against the JAX package on the same weights, batches and draws (the
harness of ``tests/test_torch_port_train_loop.py``): full fine-tuning, and
the preservation term in its epsilon form on the whole learned-sigma
output, with LoRA (the base: the model with its adapters gated off) and on
the full fine-tuning snapshot."""

from tests.test_torch_port_train_loop import _check_leaves, _run
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)


def test_full_finetune_steps_match_jax():
    """Two steps of full fine-tuning (every parameter a leaf, AdamW with
    weight decay, warmup, the clip, EMA over every leaf): loss, grad_norm
    and every leaf and EMA copy after."""
    state, model, names, leaves, ema, _ = _run("pixart", lora=False)
    _check_leaves(state, model, names, leaves, ema, False, 2)
    assert len(names) == len(list(model.parameters()))


def test_full_finetune_preservation_epsilon_matches_jax():
    """PixArt full fine-tuning with the preservation term on the initial
    snapshot (the epsilon form): the second step's term is nonzero."""
    state, model, names, leaves, ema, _ = _run("pixart", lora=False,
                                               pres=True)
    _check_leaves(state, model, names, leaves, ema, False, 2)


def test_lora_preservation_matches_jax():
    """LoRA with the epsilon-form preservation term: the same steps, and
    every adapter gate cleared afterwards."""
    from yat_tpu_torch.models.layers import AdapterDense

    state, model, names, leaves, ema, _ = _run("pixart", lora=True,
                                               pres=True)
    _check_leaves(state, model, names, leaves, ema, True, 2)
    assert all(m.lora_gate is None for m in model.modules()
               if isinstance(m, AdapterDense))
