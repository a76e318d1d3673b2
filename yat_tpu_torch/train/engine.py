"""The training engine: the host loop around the training step.

Counterpart of ``yat_tpu/train/engine.py:Trainer``, single process:
LoRA adapters attached from a seeded generator (the trainable-parameter
line), the optimizer and EMA, the empty-caption embedding for
unconditional-caption dropout, batches moved to the device, gradient
accumulation, the no-progress watchdog, the ``[engine] step i/N`` and
images/sec lines, TensorBoard scalars, validation on its cadence with the
three-failure escalation (a frontend's ``validate_fn`` samples on the EMA
copies of the trainable leaves when ``use_ema`` keeps them, and its
``validation_pipeline`` takes the ``validation_cache_interval`` key
before the first step), and the adapter export to
``{output_dir}/{step}/adapter_model.safetensors``.

Divergence from the JAX package: where ``train_unconditional_prob > 0``
and no caption encoder is attached (feature shards without validation
prompts), the JAX trainer skips the dropout silently; the port raises.

With ``lora_base_model_8bit`` (or ``_4bit``) :meth:`Trainer.initialize`
quantizes the frozen base's dense weights per output channel, as the JAX
trainer does ("base model quantized to int8"), from the weights as the
frontend built them (fp32: a frontend builds a quantized base in fp32 and
leaves the cast to the trainer), then stores the parameters that stay
floating in bf16 under ``bfloat16``; ``int8_w8a8`` sends the 8-bit base
products through ``ops.quant.w8a8_matmul`` (kernels K5 and K5b).

Not ported yet, each raises ``NotImplementedError`` naming its ROADMAP
item: full-state checkpoints and resume, the profiler window, loading
pretrained adapters, full fine-tuning and multi-process runs.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from yat_tpu_torch.adapters.builder import (
    AdapterSpec,
    adapted_modules,
    adapter_tree,
    build_adapter_params,
    count_adapter_params,
    lora_parameters,
)
from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.data.sampler import pad_embeddings
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.models.layers import AdapterDense
from yat_tpu_torch.ops.quant import quantize_params
from yat_tpu_torch.train.state import Optimizer
from yat_tpu_torch.train.step import make_train_step
from yat_tpu_torch.utils.logging import MetricLogger

# after this many consecutive validation failures the run escalates
MAX_CONSECUTIVE_VALIDATION_FAILURES = 3


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not implemented in the PyTorch "
                               f"port yet (ROADMAP queue 1, item {item})")


def adapter_spec_from_params(params: TrainingParameters
                             ) -> Optional[AdapterSpec]:
    if params.lora_rank is None or params.lora_algo in (None, "full"):
        return None
    return AdapterSpec(
        algo=params.lora_algo,
        rank=params.lora_rank,
        alpha=params.lora_alpha or params.lora_rank,
        dropout=params.lora_dropout,
        target_modules=params.lora_target_modules or (),
        use_dora=params.lora_use_dora,
        use_rslora=params.lora_use_rslora,
    )


def quantized_bits(params: TrainingParameters) -> Optional[int]:
    """The bits of the quantized base (4 wins over 8, as in the JAX
    trainer), or None for a floating base."""
    if params.lora_base_model_4bit:
        return 4
    return 8 if params.lora_base_model_8bit else None


def check_supported(params: TrainingParameters) -> None:
    """Raise for every option whose path is not ported."""
    if params.checkpoint_dir or params.resume:
        raise _not_ported("checkpoint_dir/resume (full train-state "
                          "checkpoints)", "6")
    if params.profile_dir:
        raise _not_ported("profile_dir (the profiler window of steps 10-14)",
                          "6")
    if params.lora_pretrained:
        raise _not_ported("lora_pretrained (adapter import)", "9")
    if params.use_repa:
        raise _not_ported("REPA", "10")
    if adapter_spec_from_params(params) is None:
        raise _not_ported("full fine-tuning (no LoRA rank, or lora_algo "
                          "'full')", "13")
    if params.exploration_steps:
        raise _not_ported("exploration_steps (best-of-N noise search)", "13")
    if params.use_preservation:
        raise _not_ported("use_preservation (the preservation loss)", "13")


class Trainer:
    """Host-side orchestration; frontends wire the model-specific pieces
    (``encode_captions`` and ``validate_fn`` may be attached)."""

    def __init__(self, params: TrainingParameters, model, task_loss,
                 sampler=None, device=None):
        check_supported(params)
        self.params = params
        self.model = model
        self.task_loss = task_loss
        self.sampler = sampler
        self.device = resolve_device(device)
        # validate_fn(trainer) -> {tag: image}, attached by a frontend
        self.validate_fn: Optional[Callable[["Trainer"], Dict]] = None
        # the ValidationPipeline behind validate_fn, attached by a frontend
        self.validation_pipeline = None
        self.global_step = 0
        self.logger: Optional[MetricLogger] = None
        self.optimizer: Optional[Optimizer] = None
        self.ema: Optional[List[torch.Tensor]] = None
        self._step_fn = None
        self._empty_raw: Optional[np.ndarray] = None
        self._validation_failures = 0
        # per optimizer step: {"step", "loss", "grad_norm", "lr",
        # "caption_len"}
        self.history: List[Dict[str, float]] = []
        self._step_times: List[float] = []

    # ------------------------------------------------------------------
    def initialize(self) -> None:
        params = self.params
        self.logger = MetricLogger(logdir="runs")
        os.makedirs(params.output_dir, exist_ok=True)

        if not adapted_modules(self.model):
            gen = torch.Generator(device=self.device).manual_seed(
                params.dataset_seed)
            build_adapter_params(self.model, adapter_spec_from_params(params),
                                 gen, merged=params.lora_fused_matmul)
        n_train = count_adapter_params(self.model)
        lora = {id(p) for _, p in lora_parameters(self.model)}
        n_total = sum(p.numel() for p in self.model.parameters()
                      if id(p) not in lora)
        print(f"trainable params: {n_train:,} || all params: "
              f"{n_total:,} || trainable%: {100 * n_train / n_total:.4f}")

        bits = quantized_bits(params)
        if bits is not None:
            quantize_params(self.model, bits)
            print(f"base model quantized to int{bits}")
            for m in self.model.modules():
                if isinstance(m, AdapterDense):
                    m.w8a8 = params.int8_w8a8
            if params.bfloat16:
                lora = {id(p) for _, p in lora_parameters(self.model)}
                with torch.no_grad():
                    for p in self.model.parameters():
                        if id(p) not in lora:
                            p.data = p.data.to(torch.bfloat16)

        leaves = self.trainable_leaves()
        self.optimizer = Optimizer(params, leaves)
        self.ema = ([p.detach().clone() for p in leaves] if params.use_ema
                    else None)
        self._step_fn = make_train_step(
            task_loss=self.task_loss, optimizer=self.optimizer,
            ema=self.ema, ema_decay=params.ema_decay,
            uncond_prob=params.train_unconditional_prob)

        # empty-caption embedding for unconditional-caption dropout: encode
        # '' once, pad per batch
        if params.train_unconditional_prob > 0.0:
            encode = getattr(self, "encode_captions", None)
            if encode is None:
                raise ValueError(
                    "train_unconditional_prob > 0 needs the empty-caption "
                    "embedding, and no caption encoder is attached (feature "
                    "shards without validation prompts): add "
                    "validation_prompts or set train_unconditional_prob to 0")
            self._empty_raw = np.asarray(encode([""])[0], np.float32)

    def trainable_leaves(self) -> List[torch.Tensor]:
        """The trainable leaves (the LoRA parameters), in the order of the
        optimizer's and the EMA's."""
        return [p for _, p in lora_parameters(self.model)]

    # ------------------------------------------------------------------
    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """data.sampler.Batch → tensors on the device (latents bf16 when
        ``bfloat16``)."""
        dev = self.device
        lat_dtype = torch.bfloat16 if self.params.bfloat16 else torch.float32
        out = {
            "latents": torch.as_tensor(batch.latents).to(dev, lat_dtype),
            "embeddings": torch.as_tensor(batch.embeddings).to(dev),
            "text_mask": torch.as_tensor(batch.text_mask).to(dev),
        }
        if self._empty_raw is not None:
            padded, mask = pad_embeddings([self._empty_raw],
                                          batch.embeddings.shape[1])
            out["empty_embeddings"] = torch.as_tensor(padded).to(dev)
            out["empty_text_mask"] = torch.as_tensor(mask).to(dev)
        if batch.is_regularization and self.params.dreambooth_lambda != 1.0:
            out["loss_scale"] = torch.tensor(self.params.dreambooth_lambda,
                                             dtype=torch.float32, device=dev)
        return out

    # ------------------------------------------------------------------
    def run(self) -> None:
        params = self.params
        if self.optimizer is None:
            self.initialize()
        if self.sampler is None:
            raise ValueError("no sampler configured")
        # the validation velocity-cache key applies before the loop, so a
        # key the pipeline cannot honour (an epsilon family, the dpm
        # sampler, refiner gating) fails at step 0
        pipeline = getattr(self, "validation_pipeline", None)
        if self.validate_fn is not None and pipeline is not None:
            from yat_tpu_torch.train.validation import apply_cache_interval
            apply_cache_interval(params, pipeline)
        if params.warmup_compile:
            print("[engine] warmup_compile: eager PyTorch has no programs to "
                  "compile ahead of the first step; nothing to warm")
        gen = torch.Generator(device=self.device).manual_seed(
            params.dataset_seed + 1 + self.global_step)
        try:
            self._run_loop(iter(self.sampler), gen)
        finally:
            stop = getattr(self.sampler, "stop", None)
            if stop is not None:
                stop()

    def _held_buckets(self) -> Dict[str, int]:
        buckets = getattr(self.sampler, "buckets", None)
        if isinstance(buckets, dict):
            return {k: len(v) for k, v in buckets.items() if len(v)}
        return {}

    def _run_loop(self, sampler_iter, gen: torch.Generator) -> None:
        params = self.params
        accum = params.gradient_accumulation_steps
        micro = 0
        pending = None
        empty_passes = 0
        batches_this_pass = 0
        held_prev = -1
        t_start = t_last = time.monotonic()
        while self.global_step < params.steps:
            try:
                batch = next(sampler_iter)
                batches_this_pass += 1
                empty_passes = 0
            except StopIteration:
                # watchdog: a batchless pass is progress only while the
                # held partial buckets grow
                if batches_this_pass == 0:
                    held_now = sum(self._held_buckets().values())
                    if held_now > max(held_prev, 0):
                        empty_passes = 0
                    else:
                        empty_passes += 1
                    held_prev = held_now
                    if empty_passes >= 2:
                        raise RuntimeError(
                            "sampler produced no batches and ingested no "
                            "new samples in 2 consecutive passes — the "
                            "data source cannot fill any bucket at "
                            f"batch_size={params.batch_size}. Partial "
                            f"buckets held: {self._held_buckets()}. Check "
                            "shard keys/paths and the aspect-ratio bin "
                            "table, or lower batch_size")
                else:
                    held_prev = -1
                batches_this_pass = 0
                sampler_iter = iter(self.sampler)
                continue

            lr = self.optimizer.lr
            device_batch = self._device_batch(batch)
            metrics = self._step_fn(device_batch, gen)
            micro += 1
            if micro % accum != 0:
                continue

            # log the previous step's metrics: reading them waits for the
            # device, one step late it waits for less
            if pending is not None:
                self._log_metrics(*pending)
            pending = (self.global_step + 1, metrics, lr,
                       device_batch["embeddings"].shape[1])
            self.global_step += 1
            now = time.monotonic()
            self._step_times.append(now - t_last)
            t_last = now
            if self.global_step == 1 or self.global_step % 50 == 0:
                recent = self._step_times[-50:]
                ips = params.batch_size * accum * len(recent) / sum(recent)
                print(f"[engine] step {self.global_step}/{params.steps} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"({ips:.2f} imgs/s)", flush=True)
                if self.logger is not None:
                    self.logger.add_scalar("perf/images_per_sec", ips,
                                           self.global_step)

            if self.global_step % params.num_steps_per_validation == 0:
                self._validate_and_save()

        if pending is not None:
            self._log_metrics(*pending)
        if self.global_step % params.num_steps_per_validation != 0:
            self.save_model()
        dt = time.monotonic() - t_start
        n_images = self.global_step * params.batch_size * accum
        if dt > 0:
            print(f"[engine] {self.global_step} steps, "
                  f"{n_images / dt:.2f} images/sec")

    # ------------------------------------------------------------------
    def _log_metrics(self, step: int, metrics, lr: float,
                     caption_len: int) -> None:
        rec = {"step": step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]), "lr": float(lr),
               "caption_len": int(caption_len)}
        self.history.append(rec)
        if self.logger is not None:
            self.logger.add_scalar("train/loss", rec["loss"], step)
            self.logger.add_scalar("train/grad_norm", rec["grad_norm"], step)
            self.logger.add_scalar("train/lr", rec["lr"], step)

    def _validate_and_save(self) -> None:
        if not self.params.dual_gpu and self.validate_fn is not None:
            try:
                images = self.validate_fn(self)
                for tag, img in (images or {}).items():
                    self.logger.add_image(tag, img, self.global_step)
                self._validation_failures = 0
                self.logger.add_scalar("validation/failed", 0,
                                       self.global_step)
            except Exception as e:  # noqa: BLE001 — training continues
                print(f"[Warning] validation failed: {e}")
                self._validation_failures += 1
                self.logger.add_scalar("validation/failed", 1,
                                       self.global_step)
                if (self._validation_failures
                        >= MAX_CONSECUTIVE_VALIDATION_FAILURES):
                    raise RuntimeError(
                        f"validation failed {self._validation_failures} "
                        "consecutive times — validate_fn is broken, not "
                        "flaky") from e
        self.save_model()

    # ------------------------------------------------------------------
    def save_model(self) -> str:
        """Adapters-only export to
        ``{output_dir}/{step}/adapter_model.safetensors`` (PEFT names);
        returns the file's path."""
        from yat_tpu_torch.adapters.io import save_adapter_safetensors
        out = os.path.join(self.params.output_dir, str(self.global_step))
        path = os.path.join(out, "adapter_model.safetensors")
        adapters, meta = adapter_tree(self.model)
        save_adapter_safetensors(path, adapters, meta)
        return path
