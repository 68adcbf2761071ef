"""Shape-bucketed predict engine (port of deepvision_tpu/serve/engine.py).

Incoming batches are padded up to the nearest bucket ({1, 8, 32,
max_batch} by default) and the padding rows are stripped from the outputs;
in inference mode rows are independent, so padding cannot contaminate real
outputs — pinned by tests/test_torch_serve.py against `reference`. PyTorch
runs eagerly, so a bucket here bounds the set of shapes the kernels and
cuBLAS see rather than a set of compiled programs; a CUDA graph per bucket
is the counterpart of the JAX engine's AOT executables (ROADMAP).

Dtype policy matches the JAX engine: inputs cast to the config's compute
dtype (bf16 unless the config pins f32), float outputs returned as f32.

An answer is the model's eval-mode output as a tree of host arrays: one
(n, classes) array for a classifier (its first output when it returns
several, as the JAX engine's `take_first_output`); for YOLO the decoded
`(boxes_xywh, objectness, class_probs)` triple of each of its three
scales; for CenterNet one dict {"heatmap", "size", "offset"} per stack;
for the Stacked Hourglass one heatmap array per stack; for segmentation
the int32 (n, H, W) class-id masks (the argmax of the logits, on the
device: the engine's `output_transform`). `tree_slice` and
`tree_concat` strip padding, join chunks and cut one request's rows out
of a coalesced batch; the server encodes the same tree as JSON (dicts as
objects).

Weights: seeded random ones (the config's seed), an explicit `state_dict`,
or a training workdir's checkpoint (`load_checkpoint_weights`, the
`--workdir` / `-c` of the serving CLI): restored through the config's own
trainer, the EMA weights when the checkpoint keeps them, verified against
its integrity manifest in strict mode (a corrupt checkpoint raises
`CheckpointCorruptionError` unless `verify=False`, the CLI's
`--no-verify`), with a provenance record that `/healthz` reports. GAN
configs are refused: a generator has no single logits forward to serve.

Two weight generations (hot reload and promotion, serve/reload.py and
serve/promote.py): the live one and, while a promotion runs, a staged
candidate. Each is its own module, placed and cast to the compute dtype
once, when it is staged (`stage_candidate`, `swap_variables`); a dispatch
reads its generation's module once, so a concurrent `promote_candidate`
or `drop_candidate` (one reference assignment under the engine's lock)
never mixes two generations inside a batch. No weight of a module that
serves is ever written in place.

The precision axis (`PRECISIONS`): "bf16", the config's compute policy,
and "int8", calibrated post-training quantization (serve/quantize.py,
ops/quant.py), armed by `enable_int8` and made the active precision by
the accuracy gate (`set_precision`). Each dispatch runs one precision,
the model's active one unless it asks for the other. Quantization reads
the f32 masters of each generation, kept from before the staging cast
(`_masters_of`): every staged generation, a swapped or promoted one
included, is re-quantized under the pinned activation scales, never
recalibrated. At int8 the staged module runs under the quantizer's
`Int8Mode` with its generation's int8 weights; its own float weights
serve the calls the plan keeps in float.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..core.steps import normalize_input
from ..models import build_model
from ..ops import quant
from ..utils.device import device_name, resolve_device


#: the engine's precision axis: "bf16" is the config's compute policy
#: (f32 for configs that pin f32), "int8" its calibrated quantization
PRECISIONS = ("bf16", "int8")

#: the config families the engine can build and serve
SERVED_FAMILIES = ("classification", "detection", "pose", "centernet",
                   "segmentation")


def check_served(name: str, cfg) -> None:
    """Raise unless the engine serves `cfg`'s family; a GAN config with
    the JAX engine's message."""
    if cfg.family == "gan":
        raise ValueError(
            f"config {name!r} is adversarial — serve a generator via "
            f"tools/export.py instead (no single logits apply fn)")
    if cfg.family not in SERVED_FAMILIES:
        raise ValueError(
            f"config {name!r} is {cfg.family}; the port serves "
            f"{', '.join(SERVED_FAMILIES)} models only so far")


def config_at(name: str, image_size: Optional[int] = None):
    """The registered config `name`, served at `image_size` pixels when
    given (the serving CLI's `--image-size`), else at its own."""
    cfg = get_config(name)
    if image_size and image_size != cfg.data.image_size:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   image_size=image_size))
    return cfg


def load_checkpoint_weights(name: str, workdir: str, *,
                            checkpoint=None, verbose: bool = True,
                            verify: bool = True,
                            image_size: Optional[int] = None
                            ) -> Tuple[torch.nn.Module, dict, Any]:
    """Restore a config's serving weights from a training workdir
    (deepvision_tpu/serve/engine.py::load_checkpoint_weights): the
    checkpoint (`checkpoint`: an epoch, or None / "latest") is restored
    through the config's own trainer on the CPU, and the EMA weights win
    when it keeps them: the parameters `Trainer.evaluate` scores under
    `state.ema_weights()`, with the current BatchNorm statistics. With
    nothing restorable the trainer's seeded weights serve, with a warning.
    `verify=True` restores in strict integrity mode: a checkpoint whose
    manifest does not verify raises CheckpointCorruptionError instead of
    serving corrupt weights; `verify=False` restores blindly and flags the
    weights unverified.

    Returns `(model, provenance, cfg)`; the provenance record is
    {weights: "checkpoint" | "random-init", checkpoint_epoch, verified,
    manifest_sha256, resharded}. `resharded` stays false: a checkpoint is
    whole and restores natively at any world size (no resharding is
    ported)."""
    from ..configs import trainer_class_for_config
    cfg = config_at(name, image_size)
    check_served(name, cfg)
    trainer = trainer_class_for_config(name)(cfg, device="cpu",
                                            workdir=workdir)
    try:
        trainer.init_state()
        got = trainer.resume(None if checkpoint in (None, "latest")
                             else int(checkpoint),
                             verify="strict" if verify else "off")
        if got is None and verbose:
            print(f"[serve:{cfg.name}] WARNING: nothing restorable in "
                  f"{workdir!r} — serving RANDOM weights", flush=True)
        info = trainer.ckpt.last_restore_info or {}
        if got is not None and not info.get("verified") and verbose:
            why = ("legacy checkpoint without a manifest"
                   if info.get("legacy") else "verification off")
            print(f"[serve:{cfg.name}] WARNING: serving UNVERIFIED weights "
                  f"(epoch {got}: {why})", flush=True)
        state = trainer.state
        if state.ema is not None:
            with torch.no_grad():
                for p, e in zip(state.model.parameters(), state.ema):
                    p.copy_(e)
    finally:
        trainer.close()
    provenance = {"weights": "checkpoint" if got is not None
                  else "random-init",
                  "checkpoint_epoch": got,
                  "verified": bool(info.get("verified", False)),
                  "manifest_sha256": info.get("manifest_sha256"),
                  "resharded": bool(info.get("resharded", False))}
    return state.model, provenance, trainer.config


def argmax_masks(logits: torch.Tensor) -> torch.Tensor:
    """Segmentation's answer: int32 class ids, the argmax over the last
    axis of the (n, H, W, C) logits."""
    return logits.argmax(dim=-1).to(torch.int32)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of nested tuples, lists and mappings (and of
    `rest`, trees of the same structure), keeping the structure: a mapping
    comes back as a dict with its keys in its own order."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def tree_slice(outputs: Any, lo: int, hi: int) -> Any:
    """Rows `[lo:hi]` of every leaf of an output tree."""
    return tree_map(lambda a: a[lo:hi], outputs)


def tree_concat(chunks: Sequence[Any]) -> Any:
    """Same-structure output trees joined along the batch."""
    return tree_map(lambda *xs: np.concatenate(xs), *chunks)


def weight_signature(model: torch.nn.Module) -> dict:
    """{name: (shape, dtype)} of every parameter and buffer: what a
    generation must share with the live one to be served by the same
    engine (buckets, kernels and shapes unchanged)."""
    return {k: (tuple(v.shape), v.dtype)
            for k, v in model.state_dict().items()}


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets ascending). Raises past the largest
    bucket — predict() chunks oversize batches before calling this, and the
    batcher never coalesces past max_batch."""
    if n < 1:
        raise ValueError(f"need at least one example, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class PredictEngine:
    """Bucketed predict over `model(x)` on one device.

    `predict(images)` accepts a host array of shape `(n, *example_shape)`
    (or one bare example), pads to the nearest bucket, runs ONE dispatch
    per <=max_batch chunk, and returns the host output tree (float leaves
    f32) with the padding rows stripped. Thread-safe: the model is only
    read, and each dispatch runs under `torch.inference_mode()`.

    The model must carry its compute dtype as `model.dtype` and implement
    `cast_compute_weights_()` (`models/common.py::ComputeWeights`: every
    CNN of the zoo; `models/vit.py`). With `take_first_output` (a
    classifier) a model that returns a tuple serves its first output, the
    main head; without it the whole tree is served. `output_transform`,
    when given, maps that output on the device before it goes to the host
    (segmentation's `argmax_masks`).
    """

    def __init__(self, model: torch.nn.Module, *,
                 example_shape: Sequence[int],
                 device=None,
                 buckets: Sequence[int] = (1, 8, 32),
                 max_batch: Optional[int] = None,
                 input_norm: Optional[Tuple] = None,
                 take_first_output: bool = True,
                 output_transform: Optional[Callable] = None,
                 name: str = "model", verbose: bool = True,
                 provenance: Optional[dict] = None):
        self.device = resolve_device(device)
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        max_batch = int(max_batch) if max_batch else bs[-1]
        if max_batch < bs[-1]:
            raise ValueError(f"max_batch={max_batch} below the largest "
                             f"bucket {bs[-1]}")
        if max_batch not in bs:
            bs.append(max_batch)  # the {1, 8, 32, max_batch} policy
        self.buckets: Tuple[int, ...] = tuple(bs)
        self.max_batch = max_batch
        self.example_shape = tuple(example_shape)
        self.name = name
        self.verbose = verbose
        self.provenance = dict(provenance or {"weights": "random-init"})
        self.input_norm = input_norm
        self.take_first_output = take_first_output
        self.output_transform = output_transform
        self.input_dtype = np.dtype(np.uint8 if input_norm is not None
                                    else np.float32)
        self.compute_dtype = model.dtype
        self.device_name = device_name(self.device)
        self._lock = threading.Lock()
        # weights are placed and cast to the compute dtype ONCE, when a
        # generation is staged: a per-request cast would read the f32 copy
        # and write a bf16 one on every dispatch, more weight traffic than
        # the dispatch itself needs. Norms and f32 heads stay f32 (the
        # model's policy).
        self._masters = self._masters_of(model)
        self.model = self._stage(model)
        self._signature = weight_signature(self.model)
        #: the staged candidate generation (None outside a promotion)
        self._candidate: Optional[torch.nn.Module] = None
        self.candidate_provenance: Optional[dict] = None
        self._candidate_delay_s = 0.0
        #: bucketed dispatches run so far (warmup included): every one runs
        #: the model once at its bucket's batch size
        self.dispatches = 0
        #: the same count by weight generation, "live" and "candidate"
        self.dispatches_by_generation = {"live": 0, "candidate": 0}
        #: and by precision
        self.dispatches_by_precision = {p: 0 for p in PRECISIONS}
        # -- the int8 axis (serve/quantize.py): the dispatches' default
        # precision, the gate's last decision record, and, once armed, the
        # quantizer and each generation's int8 weights
        self.precision = "bf16"
        self.quant_decision: Optional[dict] = None
        self._quantizer = None
        self._qweights = None
        self._qcandidate = None
        self._candidate_masters: Optional[dict] = None

    @classmethod
    def from_config(cls, name: str, *, device=None,
                    buckets: Sequence[int] = (1, 8, 32),
                    max_batch: Optional[int] = None,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                    workdir: Optional[str] = None, checkpoint=None,
                    image_size: Optional[int] = None,
                    verbose: bool = True,
                    verify: bool = True) -> "PredictEngine":
        """Build an engine for a registered config: weights restored from
        the training `workdir` (`load_checkpoint_weights`; `checkpoint` an
        epoch or "latest"; `verify` False serves a checkpoint that fails
        or skips verification, flagged unverified), or `state_dict` (e.g. JAX params carried over
        by utils/flax_convert.py), or drawn from `cfg.seed` through a
        `torch.Generator`. `image_size` serves at that many pixels (default:
        the config's)."""
        device = resolve_device(device)   # fail before building anything
        cfg = config_at(name, image_size)
        check_served(name, cfg)
        if workdir is not None:
            model, provenance, cfg = load_checkpoint_weights(
                name, workdir, checkpoint=checkpoint, verbose=verbose,
                verify=verify, image_size=image_size)
        else:
            model = build_model(cfg)
            provenance = {"weights": "random-init", "seed": cfg.seed}
            if state_dict is not None:
                model.load_state_dict(state_dict)
                provenance = {"weights": "state_dict"}
        input_norm = ((cfg.data.mean, cfg.data.std)
                      if cfg.data.normalize_on_device else None)
        size = cfg.data.image_size
        return cls(model, example_shape=(size, size, cfg.data.channels),
                   device=device, buckets=buckets, max_batch=max_batch,
                   input_norm=input_norm,
                   take_first_output=cfg.family == "classification",
                   output_transform=(argmax_masks
                                     if cfg.family == "segmentation"
                                     else None),
                   name=cfg.name, verbose=verbose, provenance=provenance)

    # -- weight generations ------------------------------------------------

    @staticmethod
    def _masters_of(model: torch.nn.Module) -> dict:
        """{name: the f32 parameter} of an unstaged module: references to
        the master weights that the staging cast replaces, the source every
        quantization of this generation reads. No copy is made, but the
        references keep the f32 tensors alive beside the staged copy (host
        memory on a card: 4 bytes per parameter of each generation)."""
        return {n: p.detach() for n, p in model.named_parameters()}

    def _stage(self, model: torch.nn.Module) -> torch.nn.Module:
        """`model` in eval mode, cast to its compute dtype and placed on the
        device, resident before it returns (the copy is off the request
        path: a generation goes live only once staged)."""
        staged = model.eval().cast_compute_weights_().to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return staged

    def _check_signature(self, model: torch.nn.Module, what: str) -> None:
        if model.dtype != self.compute_dtype \
                or weight_signature(model) != self._signature:
            raise ValueError(
                f"refusing to {what} for {self.name!r}: the weights do not "
                f"match the served ones (parameter names, shapes or dtypes "
                f"differ) — a changed architecture needs a new engine, not "
                f"a swap")

    def swap_variables(self, model: torch.nn.Module,
                       provenance: Optional[dict] = None) -> None:
        """Atomically make `model` (a module of the same architecture, as
        `load_checkpoint_weights` returns) the live generation — the hot
        reload primitive (serve/reload.py). Staged (placed, cast, resident)
        before the swap; the swap itself is one reference assignment under
        the lock, so a dispatch in flight finishes on the weights it
        started with and every later one serves the new ones. A module
        whose signature differs is refused (ValueError). With int8 armed the
        new generation is quantized from its f32 masters first, under the
        pinned activation scales, and its int8 weights go live with it."""
        masters = self._masters_of(model)
        staged = self._stage(model)
        self._check_signature(staged, "hot swap")

        def install(qweights):
            self.model = staged
            self._masters = masters
            self._qweights = qweights
            if provenance is not None:
                self.provenance = dict(provenance)

        self._install_quantized(masters, install)

    @property
    def has_candidate(self) -> bool:
        return self._candidate is not None

    def stage_candidate(self, model: torch.nn.Module,
                        provenance: Optional[dict] = None, *,
                        inject_delay_s: float = 0.0) -> None:
        """Host a second weight generation beside the live one (the
        promotion pipeline's candidate), its own module with its own cast
        copy of the weights. Same signature contract as `swap_variables`.
        Dispatches keep defaulting to the live generation: only callers
        that ask for `generation="candidate"` (the shadow eval and the
        canary-routed batches) see it. `inject_delay_s` is the canary
        latency fault (DEEPVISION_FAULT_PROMOTE_REGRESS=<epoch>:latency):
        every candidate dispatch sleeps that long. With int8 armed the
        candidate exists at both precisions: the canary runs it at the
        model's active precision."""
        masters = self._masters_of(model)
        staged = self._stage(model)
        self._check_signature(staged, "stage a candidate")

        def install(qweights):
            self._candidate = staged
            self._candidate_masters = masters
            self._qcandidate = qweights
            self.candidate_provenance = (dict(provenance) if provenance
                                         else None)
            self._candidate_delay_s = float(inject_delay_s)

        self._install_quantized(masters, install)

    def promote_candidate(self) -> dict:
        """Flip the candidate live — one reference assignment under the
        lock: batches in flight finish on the generation they read, every
        later dispatch serves the new one. Returns the live provenance."""
        with self._lock:
            if self._candidate is None:
                raise RuntimeError(f"{self.name!r} has no staged candidate "
                                   f"to promote")
            self.model = self._candidate
            self._masters = self._candidate_masters
            self._qweights = self._qcandidate   # int8 in lockstep
            if self.candidate_provenance is not None:
                self.provenance = dict(self.candidate_provenance)
            self._drop_locked()
            return self.provenance

    def drop_candidate(self) -> None:
        """Retreat to the incumbent: unstage the candidate (its memory goes
        once no dispatch holds it). Later `generation="candidate"`
        dispatches resolve to the live weights, so a request racing a
        rollback still gets one generation's answer."""
        with self._lock:
            self._drop_locked()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _drop_locked(self) -> None:
        self._candidate = None
        self._candidate_masters = None
        self._qcandidate = None
        self.candidate_provenance = None
        self._candidate_delay_s = 0.0

    # -- the int8 precision axis (serve/quantize.py) -----------------------

    @property
    def int8_enabled(self) -> bool:
        return self._quantizer is not None

    def _quantize(self, quantizer, masters: dict) -> list:
        """One generation's int8 weights from its f32 masters, placed on
        the device, resident before they return."""
        qweights = [q.to(self.device) for q in quantizer.quantize(masters)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return qweights

    def _install_quantized(self, masters: dict, install) -> None:
        """`install(qweights)` under the lock, `qweights` the int8 weights
        of `masters` under the quantizer armed at that moment (None while
        int8 is off). The quantization runs outside the lock; if int8 was
        armed or disarmed meanwhile it runs again, so a generation never
        goes live beside another quantizer's weights."""
        with self._lock:
            quantizer = self._quantizer
        while True:
            qweights = (self._quantize(quantizer, masters)
                        if quantizer is not None else None)
            with self._lock:
                if quantizer is self._quantizer:
                    install(qweights)
                    return
                quantizer = self._quantizer

    def enable_int8(self, quantizer, verbose: bool = True) -> None:
        """Arm the int8 twin beside bf16, the one-time arm cost
        (serve/quantize.arm_int8 drives it and gates the result before it
        flips `precision`): each generation's weights quantized from its
        f32 masters, and the plan checked at every bucket (a bucket whose
        forward plans another op sequence raises ValueError). The active
        precision is not changed here."""
        for b in self.buckets:
            t0 = time.perf_counter()
            x = np.zeros((b, *self.example_shape), self.input_dtype)
            with torch.inference_mode():
                quantizer.check_plan(self.model,
                                     lambda: self.forward(self.model, x))
            if self.verbose and verbose:
                print(f"[serve:{self.name}] int8 bucket {b}: planned in "
                      f"{time.perf_counter() - t0:.2f}s", flush=True)
        # quantize both generations outside the lock; a swap or a staging
        # that lands meanwhile makes the ones it replaced stale: again
        with self._lock:
            live, cand = self._masters, self._candidate_masters
        while True:
            qlive = self._quantize(quantizer, live)
            qcand = (self._quantize(quantizer, cand) if cand is not None
                     else None)
            with self._lock:
                if live is self._masters \
                        and cand is self._candidate_masters:
                    self._quantizer, self._qweights = quantizer, qlive
                    self._qcandidate = qcand
                    return
                live, cand = self._masters, self._candidate_masters

    def disable_int8(self) -> None:
        """Back to bf16 only (the gate's refusal): the quantizer and the
        int8 weights go, the active precision is bf16. `quant_decision`
        stays: /healthz shows why int8 is off."""
        with self._lock:
            self.precision = "bf16"
            self._quantizer = None
            self._qweights = None
            self._qcandidate = None

    def _check_precision_locked(self, precision: str) -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r} "
                             f"(expected one of {PRECISIONS})")
        if precision == "int8" and self._quantizer is None:
            raise ValueError(
                f"int8 serving is not armed for {self.name!r} — the "
                f"calibration gate has not passed (see /healthz quant; "
                f"serve/quantize.arm_int8, or --serve-precision int8)")

    def set_precision(self, precision: str) -> None:
        """Flip the ACTIVE precision (of dispatches that ask for none).
        int8 needs the int8 twin armed."""
        with self._lock:
            self._check_precision_locked(precision)
            self.precision = precision

    def _resolve_precision(self, precision: Optional[str]) -> str:
        """`precision`, or the active one for None; raises ValueError for
        an unknown or unarmed one (the batcher's check at the door)."""
        with self._lock:
            precision = self.precision if precision is None else precision
            self._check_precision_locked(precision)
            return precision

    def weight_bytes_per_chip(self) -> dict:
        """Weight bytes resident on the card per precision: "bf16" the
        staged module's floating leaves, "int8" (None until armed) the
        int8 weights with their scales plus the staged leaves the plan
        keeps in float. Both stay resident while int8 is armed."""
        with self._lock:
            model, quantizer, qweights = (self.model, self._quantizer,
                                          self._qweights)
        floats = {k: v for k, v in model.state_dict().items()
                  if v.is_floating_point()}
        int8 = None
        if quantizer is not None:
            planned = quantizer.plan.params
            int8 = (quant.tree_nbytes(t for q in qweights for t in (q.w, q.s))
                    + quant.tree_nbytes(v for k, v in floats.items()
                                        if k not in planned))
        return {"bf16": quant.tree_nbytes(floats.values()), "int8": int8}

    # -- dispatch ----------------------------------------------------------

    def forward(self, model: torch.nn.Module, x: np.ndarray) -> Any:
        """`model`'s eval forward of the host batch `x` on the device, as
        served (normalized input, first output, output transform): the
        device output tree. Call it under `torch.inference_mode()`."""
        images = torch.from_numpy(x).to(self.device)
        out = model(normalize_input(images, self.input_norm,
                                    self.compute_dtype))
        if self.take_first_output and isinstance(out, (tuple, list)):
            out = out[0]
        if self.output_transform is not None:
            out = self.output_transform(out)
        return out

    def _run(self, x: np.ndarray,
             model: Optional[torch.nn.Module] = None,
             int8: Optional[tuple] = None) -> Any:
        """One forward of `model` (default: the live one) at exactly x's
        batch size, in int8 when `int8` is a (quantizer, int8 weights)
        pair; the host output tree."""
        model = self.model if model is None else model
        with torch.inference_mode():
            if int8 is None:
                out = self.forward(model, x)
            else:
                quantizer, qweights = int8
                out = quantizer.run(lambda: self.forward(model, x), qweights)
            return tree_map(lambda t: (t.float() if t.is_floating_point()
                                       else t).cpu().numpy(), out)

    def _resolve(self, generation: Optional[str], precision: Optional[str]
                 ) -> Tuple[torch.nn.Module, float, str, dict, str,
                            Optional[tuple]]:
        """One read, under the lock, of what a dispatch runs: the
        generation's (module, injected delay, name, provenance), the
        precision, and at int8 the (quantizer, that generation's int8
        weights) pair, so a concurrent swap, promotion, rollback or
        disarm never mixes two states inside a batch. A candidate that is
        gone resolves to live."""
        if generation not in (None, "live", "candidate"):
            raise ValueError(f"unknown weight generation {generation!r} "
                             f"(expected 'live' or 'candidate')")
        with self._lock:
            precision = self.precision if precision is None else precision
            self._check_precision_locked(precision)
            if generation == "candidate" and self._candidate is not None:
                model, delay_s, name = (self._candidate,
                                        self._candidate_delay_s, "candidate")
                provenance = self.candidate_provenance or {}
                qweights = self._qcandidate
            else:
                model, delay_s, name = self.model, 0.0, "live"
                provenance, qweights = self.provenance, self._qweights
            int8 = ((self._quantizer, qweights) if precision == "int8"
                    else None)
        return model, delay_s, name, provenance, precision, int8

    def dispatch(self, images, generation: Optional[str] = None,
                 precision: Optional[str] = None) -> Tuple[Any, str, dict]:
        """ONE bucketed dispatch of at most max_batch examples on
        `generation`'s weights at `precision` (None: the active one):
        `(outputs, the generation that served it, that generation's
        provenance)`, read together, so the batcher can label every answer
        with the weights that computed it even across a concurrent swap,
        promotion or rollback."""
        x = self._coerce(images)
        model, delay_s, resolved, provenance, precision, int8 = \
            self._resolve(generation, precision)
        if delay_s > 0:
            time.sleep(delay_s)   # the injected canary latency fault
        n = x.shape[0]
        b = pick_bucket(n, self.buckets)
        if b != n:
            x = np.pad(x, [(0, b - n)] + [(0, 0)] * (x.ndim - 1))
        with self._lock:
            self.dispatches += 1
            self.dispatches_by_generation[resolved] += 1
            self.dispatches_by_precision[precision] += 1
        return (tree_slice(self._run(x, model, int8), 0, n), resolved,
                provenance)

    def warmup(self) -> None:
        """One blocking dispatch per bucket: absorbs first-call allocation,
        kernel build and cuBLAS setup so the first request doesn't pay it."""
        x = np.zeros((self.max_batch, *self.example_shape), self.input_dtype)
        for b in self.buckets:
            t0 = time.perf_counter()
            self.dispatch(x[:b])
            if self.verbose:
                print(f"[serve:{self.name}] bucket {b}: warm in "
                      f"{time.perf_counter() - t0:.2f}s on "
                      f"{self.device_name}", flush=True)

    def _coerce(self, images) -> np.ndarray:
        x = np.asarray(images, self.input_dtype)
        if x.shape == self.example_shape:
            x = x[None]
        if x.ndim != len(self.example_shape) + 1 \
                or x.shape[1:] != self.example_shape:
            raise ValueError(
                f"expected (n, {', '.join(map(str, self.example_shape))}) "
                f"(or one bare example), got {x.shape}")
        return x

    def predict(self, images, generation: Optional[str] = None,
                precision: Optional[str] = None) -> Any:
        """Host-in host-out bucketed prediction (pads, dispatches, strips).
        Oversize batches run as max_batch chunks plus one tail bucket.
        `generation` selects the weights ('live'/None, or 'candidate' while
        a promotion has one staged), `precision` the ladder's rung ('bf16'
        or 'int8'; None: the active one); each dispatch runs one of each."""
        x = self._coerce(images)
        chunks = [self.dispatch(x[i:i + self.max_batch], generation,
                                precision)[0]
                  for i in range(0, x.shape[0], self.max_batch)]
        return chunks[0] if len(chunks) == 1 else tree_concat(chunks)

    def reference(self, images, generation: Optional[str] = None) -> Any:
        """Un-bucketed predict at the exact batch size on `generation`'s
        weights — the oracle the padding-equivalence checks hold the
        bucketed path against. Always the bf16 rung: the accuracy
        reference the int8 gate scores against."""
        model = self._resolve(generation, "bf16")[0]
        return self._run(self._coerce(images), model)

    # -- measurement -------------------------------------------------------

    def measure_batch_ms(self, bucket: Optional[int] = None,
                         iters: int = 5,
                         precision: Optional[str] = None) -> float:
        """Steady-state wall time of one dispatch of `bucket` (default
        max_batch) at `precision` (default: the active one), host input
        to host output, in ms — the "one batch compute time" term of the
        serving latency contract."""
        b = pick_bucket(bucket or self.max_batch, self.buckets)
        x = np.zeros((b, *self.example_shape), self.input_dtype)
        model, _, _, _, _, int8 = self._resolve(None, precision)
        self._run(x, model, int8)  # warm; _run ends in a device-to-host
        t0 = time.perf_counter()   # copy, so each timed call includes the
        for _ in range(iters):     # device work
            self._run(x, model, int8)
        return (time.perf_counter() - t0) / iters * 1000.0
