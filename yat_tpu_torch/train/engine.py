"""The training engine: the host loop around the training step.

Counterpart of ``yat_tpu/train/engine.py:Trainer``, single process:
LoRA adapters attached from a seeded generator (the trainable-parameter
line), or full fine-tuning (no adapter spec: every parameter is a
trainable leaf, ``unfreeze_modules`` masks which of them update), the
optimizer and EMA, the frozen snapshot of the preservation term under
full fine-tuning, exploration steps, the empty-caption embedding for
unconditional-caption dropout, batches moved to the device, gradient
accumulation, the no-progress watchdog, the ``[engine] step i/N`` and
images/sec lines, TensorBoard scalars, validation on its cadence with the
three-failure escalation (a frontend's ``validate_fn`` samples on the EMA
copies of the trainable leaves when ``use_ema`` keeps them, and its
``validation_pipeline`` takes the ``validation_cache_interval`` key
before the first step), full train-state checkpoints on the validation
cadence (``checkpoint_dir``; ``resume`` restores the latest once
everything is built, and the run skips the batches it consumed), the
``torch.profiler`` window of steps 10-14 (``profile_dir``), and the export
to ``{output_dir}/{step}/``: ``adapter_model.safetensors`` (adapters) or
``model.safetensors`` (full fine-tuning, fp32, flat flax keys), with the
frontend's ``config.json`` beside it and an upload to ``output_repo``.

Divergences from the JAX package: where ``train_unconditional_prob > 0``
and no caption encoder is attached (feature shards without validation
prompts), the JAX trainer skips the dropout silently; the port raises.
The JAX profiler window stops only when a batch arrives at step 15, so a
run of 15 steps or fewer never writes its trace; the port also stops it
when the run ends.  ``unfreeze_modules`` that match no parameter raise.

With ``lora_base_model_8bit`` (or ``_4bit``) :meth:`Trainer.initialize`
quantizes the frozen base's dense weights per output channel, as the JAX
trainer does ("base model quantized to int8"), from the weights as the
frontend built them (fp32: a frontend builds a quantized base in fp32 and
leaves the cast to the trainer), then stores the parameters that stay
floating in bf16 under ``bfloat16``; ``int8_w8a8`` sends the 8-bit base
products through ``ops.quant.w8a8_matmul`` (kernels K5 and K5b).

Batches come from any sampler: feature shards, or raw images encoded on
the fly (``train/encode.py``), whose ``skip_batches`` makes a resume's
fast-forward encode-free; Dreambooth's regularization batches scale the
loss by ``dreambooth_lambda``; a frontend's ``batch_transform`` adds its
family's entries to each device batch (SDXL's ``time_ids`` and pooled
text).

Adapters of every kind (LoRA, DoRA, LoHa, LoKr, FourierFT) train, and
``lora_pretrained`` loads their leaves from a file after they are built
(``adapters/io.load_adapter_safetensors``: the export of either package,
bare flax paths or a real PEFT file).  A frontend's generic REPA head
(``repa_head``, SANA) trains beside the adapters under the name
``repa_head`` (or beside the parameters under full fine-tuning): the
optimizer, the EMA, the checkpoint and the export cover it.  The batch
carries the DINOv2 tokens (``repa_features``) that the on-the-fly
sampler encodes.  The trainer is single-process (ROADMAP item 12).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from yat_tpu_torch.adapters.builder import (
    AdapterSpec,
    adapted_modules,
    adapter_parameters,
    adapter_tree,
    build_adapter_params,
    count_adapter_params,
    load_pretrained_adapters,
)
from yat_tpu_torch.config import TrainingParameters
from yat_tpu_torch.convert import flax_named_parameters
from yat_tpu_torch.data.sampler import pad_embeddings
from yat_tpu_torch.device import resolve_device
from yat_tpu_torch.models.layers import AdapterDense
from yat_tpu_torch.ops.quant import quantize_params
from yat_tpu_torch.train.state import Optimizer, unfreeze_mask
from yat_tpu_torch.train.step import make_train_step
from yat_tpu_torch.utils.logging import MetricLogger

# after this many consecutive validation failures the run escalates
MAX_CONSECUTIVE_VALIDATION_FAILURES = 3


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
        n_frequency=params.fourierft_n_frequency,
        fourier_alpha=params.fourierft_alpha,
    )


def quantized_bits(params: TrainingParameters) -> Optional[int]:
    """The bits of the quantized base (4 wins over 8, as in the JAX
    trainer), or None for a floating base."""
    if params.lora_base_model_4bit:
        return 4
    return 8 if params.lora_base_model_8bit else None


def stored_dtype(params: TrainingParameters) -> Optional[torch.dtype]:
    """The dtype ``make_trainer`` stores the denoiser's parameters in:
    bf16 for a frozen LoRA base under ``bfloat16``; None (fp32) for a
    quantized base, which the trainer quantizes from fp32, and under full
    fine-tuning, whose leaves are fp32 masters cast at use, as in the JAX
    trainer."""
    if (params.bfloat16 and quantized_bits(params) is None
            and adapter_spec_from_params(params) is not None):
        return torch.bfloat16
    return None


# the axes of the JAX package's device mesh (``yat_tpu/parallel/mesh.py``)
MESH_AXES = ("dp", "fsdp", "tp", "sp")
_SAID = set()


def check_mesh_shape(mesh_shape: Optional[Dict[str, int]],
                     devices: int = 1) -> None:
    """Raise when ``mesh_shape`` asks for more devices than the trainer
    uses (one: the port is single-process until ROADMAP item 12), as the
    JAX package's ``create_mesh`` does when its mesh outgrows the devices.
    No key, or a mesh of one, trains as before."""
    if not mesh_shape:
        return
    need = 1
    for ax in MESH_AXES:
        need *= int(mesh_shape.get(ax, 1))
    if need > devices:
        raise ValueError(
            f"mesh_shape {dict(mesh_shape)} needs {need} devices; the "
            f"PyTorch port trains on {devices} (distribution is ROADMAP "
            "item 12): drop mesh_shape or set it to 1 device")


def say_once(key: str, msg: str) -> None:
    """Print ``msg`` the first time ``key`` is seen in this process."""
    if key not in _SAID:
        _SAID.add(key)
        print(msg)


class Trainer:
    """Host-side orchestration; frontends wire the model-specific pieces
    (``encode_captions`` and ``validate_fn`` may be attached)."""

    def __init__(self, params: TrainingParameters, model, task_loss,
                 sampler=None, device=None, preservation_loss=None,
                 batch_transform: Optional[Callable] = None):
        self.params = params
        # batch_transform(batch, out) -> out: a family's extra entries of
        # the device batch (SDXL's time_ids and pooled text), as host
        # arrays or tensors
        self.batch_transform = batch_transform
        self.model = model
        self.task_loss = task_loss
        self.sampler = sampler
        self.preservation_loss = preservation_loss
        self.device = resolve_device(device)
        check_mesh_shape(params.mesh_shape)
        if params.compilation_cache_dir:
            say_once("compilation_cache_dir", "[engine] compilation_cache_dir "
                     f"{params.compilation_cache_dir!r} is not read: it is "
                     "an XLA cache and the PyTorch port compiles no XLA")
        # validate_fn(trainer) -> {tag: image}, attached by a frontend
        self.validate_fn: Optional[Callable[["Trainer"], Dict]] = None
        # the ValidationPipeline behind validate_fn, attached by a frontend
        self.validation_pipeline = None
        self.global_step = 0
        self.logger: Optional[MetricLogger] = None
        self.optimizer: Optional[Optimizer] = None
        self.ema: Optional[List[torch.Tensor]] = None
        # the initial parameters, the preservation term's base under full
        # fine-tuning ({parameter name: tensor})
        self.frozen_base: Optional[Dict[str, torch.Tensor]] = None
        # the export's config.json (architecture flags), set by a frontend
        self.model_config_json: Optional[Dict[str, Any]] = None
        # the generic REPA projection head (ops/repa.py), set by a frontend
        self.repa_head: Optional[torch.nn.Module] = None
        self._step_fn = None
        self._profiler = None
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

        spec = adapter_spec_from_params(params)
        if spec is not None:
            self._attach_adapters(spec)
        else:
            # full fine-tuning: every parameter is a trainable leaf (the
            # JAX trainer quantizes no base here)
            for p in self.model.parameters():
                p.requires_grad_(True)

        names = self.trainable_names()
        mask = None
        if params.unfreeze_modules:
            mask = unfreeze_mask(names, params.unfreeze_modules)
            if not any(mask):
                raise ValueError(
                    f"unfreeze_modules {list(params.unfreeze_modules)} "
                    "matched no parameter; the dotted flax paths include "
                    f"{names[:8]}")
            print(f"unfreeze_modules: {sum(mask)} of {len(mask)} leaves "
                  "update")
        leaves = self.trainable_leaves()
        self.optimizer = Optimizer(params, leaves, mask)
        self.ema = ([p.detach().clone() for p in leaves] if params.use_ema
                    else None)
        if (params.use_preservation and self.preservation_loss is not None
                and spec is None):
            self.frozen_base = {n: p.detach().clone()
                                for n, p in self.model.named_parameters()}
        self._step_fn = make_train_step(
            task_loss=self.task_loss, optimizer=self.optimizer,
            ema=self.ema, ema_decay=params.ema_decay,
            uncond_prob=params.train_unconditional_prob,
            exploration_steps=params.exploration_steps,
            preservation_ratio=(params.preservation_ratio
                                if params.use_preservation else 0.0),
            preservation_loss=self.preservation_loss,
            frozen_base=self.frozen_base)

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

        if params.checkpoint_dir and params.resume:
            self.restore_checkpoint()

    def _attach_adapters(self, spec: AdapterSpec) -> None:
        """The adapters from the seeded generator (unless attached
        already), their leaves from ``lora_pretrained`` when set, the
        trainable-parameter line, and the quantized base."""
        params = self.params
        if not adapted_modules(self.model):
            gen = torch.Generator(device=self.device).manual_seed(
                params.dataset_seed)
            build_adapter_params(self.model, spec, gen,
                                 merged=params.lora_fused_matmul)
        if params.lora_pretrained:
            load_pretrained_adapters(self.model, params.lora_pretrained)
            print(f"[engine] adapters loaded from {params.lora_pretrained}")
        n_train = count_adapter_params(self.model)
        lora = {id(p) for _, p in adapter_parameters(self.model)}
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
                with torch.no_grad():
                    for p in self.model.parameters():
                        if id(p) not in lora:
                            p.data = p.data.to(torch.bfloat16)

    def full_finetune(self) -> bool:
        return adapter_spec_from_params(self.params) is None

    def _trainable(self):
        named = (flax_named_parameters(self.model) if self.full_finetune()
                 else adapter_parameters(self.model))
        if self.repa_head is not None:
            named = named + [(f"repa_head.{n}", p) for n, p in
                             flax_named_parameters(self.repa_head)]
        return named

    def trainable_leaves(self) -> List[torch.Tensor]:
        """The trainable leaves (the adapter leaves, or under full
        fine-tuning every parameter; then the REPA head's), in the order of
        the optimizer's and the EMA's."""
        return [p for _, p in self._trainable()]

    def trainable_names(self) -> List[str]:
        """The dotted flax paths of :meth:`trainable_leaves`."""
        return [n for n, _ in self._trainable()]

    def train_state(self) -> Dict[str, Any]:
        """Everything a checkpoint holds, as the live tensors: the step,
        the model's state dict (a quantized base's payloads and scales
        included), the optimizer's state, the EMA copies and the frozen
        snapshot."""
        return {"step": self.global_step,
                "model": self.model.state_dict(),
                "repa_head": (None if self.repa_head is None
                              else self.repa_head.state_dict()),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema, "frozen_base": self.frozen_base}

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
        if batch.repa_features is not None:
            out["repa_features"] = torch.as_tensor(batch.repa_features).to(
                dev, torch.float32)
        if batch.is_regularization and self.params.dreambooth_lambda != 1.0:
            out["loss_scale"] = torch.tensor(self.params.dreambooth_lambda,
                                             dtype=torch.float32, device=dev)
        if self.batch_transform is not None:
            out = {k: torch.as_tensor(v).to(dev) for k, v in
                   self.batch_transform(batch, out).items()}
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
        # the start step seeds the generator, so a resumed run draws fresh
        # noise instead of replaying what the checkpointed run consumed
        gen = torch.Generator(device=self.device).manual_seed(
            params.dataset_seed + 1 + self.global_step)
        sampler_iter = None
        if self.global_step > 0 and params.resume_data_fastforward:
            sampler_iter = self._fastforward_data(
                self.global_step * params.gradient_accumulation_steps)
        try:
            self._run_loop(sampler_iter or iter(self.sampler), gen)
        finally:
            # a run that ends inside the window still writes its trace
            self._stop_profiler()
            stop = getattr(self.sampler, "stop", None)
            if stop is not None:
                stop()

    def _fastforward_data(self, n_batches: int):
        """Skip the ``n_batches`` the checkpointed run consumed: the
        sampler replays a deterministic stream, so skipping continues on
        unseen data.  The encode path's samplers skip without encoding
        (``skip_batches``); any other sampler, or one that raises
        ``SkipUnsupported``, is drained.  A drain raises after two passes
        that yield nothing."""
        t0 = time.monotonic()
        skip = getattr(self.sampler, "skip_batches", None)
        if skip is not None:
            from yat_tpu_torch.train.encode import SkipUnsupported
            try:
                skip(n_batches)
                print(f"[engine] data fast-forward: skipped {n_batches} "
                      f"batches (encode-free) in "
                      f"{time.monotonic() - t0:.1f}s")
                return iter(self.sampler)
            except SkipUnsupported:
                pass
        it = iter(self.sampler)
        done, dry = 0, 0
        while done < n_batches:
            try:
                next(it)
                done += 1
                dry = 0
            except StopIteration:
                dry += 1
                if dry >= 2:
                    raise RuntimeError(
                        f"data fast-forward stalled at {done}/{n_batches} "
                        "batches — the dataset no longer yields what the "
                        "checkpointed run consumed (disable "
                        "resume_data_fastforward to start the stream over)")
                it = iter(self.sampler)
        print(f"[engine] data fast-forward: skipped {n_batches} batches in "
              f"{time.monotonic() - t0:.1f}s")
        return it

    def _profile_window(self) -> None:
        """torch.profiler over the steps from 10 to 14: started when a
        batch arrives at step 10, stopped when one arrives at step 15 (or
        when the run ends first)."""
        profile_dir = self.params.profile_dir
        if not profile_dir:
            return
        if self.global_step == 10 and self._profiler is None:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(profile_dir))
            self._profiler.start()
        elif self._profiler is not None and self.global_step >= 15:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        print(f"[engine] profiler trace in {self.params.profile_dir}")

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
        first_step = self.global_step
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

            self._profile_window()
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
        if params.checkpoint_dir:
            from yat_tpu_torch.train.checkpoint import wait_for_checkpoints
            wait_for_checkpoints(params.checkpoint_dir)
        dt = time.monotonic() - t_start
        # this run's steps only (a resumed run starts past 0)
        n_images = (self.global_step - first_step) * params.batch_size * accum
        if dt > 0:
            print(f"[engine] {self.global_step - first_step} steps, "
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
        if self.params.checkpoint_dir:
            self.save_checkpoint()

    # ------------------------------------------------------------------
    def save_model(self) -> str:
        """Weights-only export to ``{output_dir}/{step}``: the adapters as
        ``adapter_model.safetensors`` (PEFT names), or under full
        fine-tuning the model as ``model.safetensors`` (fp32, flat flax
        keys in the flax layouts), with a REPA head under ``repa_head``; ``config.json`` from
        ``model_config_json`` beside it; then the upload to
        ``output_repo``.  Returns the weights file's path."""
        out = os.path.join(self.params.output_dir, str(self.global_step))
        head = {}
        if self.repa_head is not None:
            from yat_tpu_torch.ops.repa import head_tree
            head = {"repa_head": head_tree(self.repa_head)}
        if self.full_finetune():
            from yat_tpu_torch.convert import flax_params
            from yat_tpu_torch.train.checkpoint import save_params_only
            save_params_only(out, {**flax_params(self.model), **head})
            path = os.path.join(out, "model.safetensors")
        else:
            from yat_tpu_torch.adapters.io import save_adapter_safetensors
            path = os.path.join(out, "adapter_model.safetensors")
            adapters, meta = adapter_tree(self.model)
            save_adapter_safetensors(path, {**adapters, **head}, meta)
        if self.model_config_json:
            with open(os.path.join(out, "config.json"), "w") as f:
                json.dump(self.model_config_json, f, indent=2)
        if self.params.output_repo:
            self._push_to_hub(out)
        return path

    def _push_to_hub(self, folder: str) -> None:
        """Upload the export to the ``output_repo`` hub repository under
        ``{step}/``; without ``huggingface_hub``, or when the upload
        fails, print a warning and go on."""
        try:
            from huggingface_hub import HfApi
            HfApi().upload_folder(folder_path=folder,
                                  repo_id=self.params.output_repo,
                                  path_in_repo=str(self.global_step))
            print(f"[engine] pushed {folder} to {self.params.output_repo}")
        except Exception as e:  # noqa: BLE001 — offline or unauthenticated
            print(f"[Warning] output_repo upload failed: {e}")

    def save_checkpoint(self) -> None:
        """The whole train state as step ``global_step`` of
        ``checkpoint_dir`` (copied to the host now, written in the
        background)."""
        from yat_tpu_torch.train.checkpoint import save_train_state
        save_train_state(self.params.checkpoint_dir, self.train_state(),
                         self.global_step)

    def restore_checkpoint(self) -> None:
        """The latest step of ``checkpoint_dir`` into the live state, in
        place; nothing when the directory holds none."""
        from yat_tpu_torch.train.checkpoint import restore_train_state
        restored, step = restore_train_state(self.params.checkpoint_dir,
                                             self.train_state())
        if restored is None:
            return
        self.global_step = step
        self.optimizer.count = restored["optimizer"]["count"]
        self.optimizer.mini_step = restored["optimizer"]["mini_step"]
        print(f"[engine] resumed from step {step}")
