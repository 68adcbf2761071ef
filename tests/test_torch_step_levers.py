"""The training step's levers in the port (deepvision_tpu_torch/core/
{steps,remat,train_state,trainer,detection,centernet,pose,segment,gan}.py)
against the JAX package on the CPU.

- **Mixup and CutMix.** A vit_tiny-shaped ViT (32 px, patch 8, 2 blocks,
  10 classes, f32, dropout 0, batch 8) trains two steps in both packages
  from the same weights (Flax shapes filled from numpy) with SGD. The
  port's apply is given the draws the JAX step itself makes, recomputed
  here with `jax.random` from the step's own keys (fold_in(fold_in(rng,
  step), 1), split in 3). Loss: 2e-5 relative (f32; measured at most
  2.8e-7); top-1/top-5: equal. CutMix's box and lam against the JAX step's own
  arithmetic: exactly.
- **`grad_norm`** against the JAX step's (`optax.global_norm` of its
  gradients): 1e-5 relative (measured at most 5.4e-7); and
  `maybe_grad_norm` against
  `optax.global_norm` on random trees.
- **Remat** against no remat, one step of the port in each family (a ViT
  with dropout 0.1, a ResNet-50 cut to one block a stage, yolov3 at a
  quarter width, CenterNet and the Stacked Hourglass cut in depth and
  width, the U-Net of unet_synthetic), at 32-64 px: the gradients, the
  loss and the BatchNorm statistics equal to 1e-6 (f32; the recompute is
  the same arithmetic, so they come out bit for bit on this CPU), and the
  recompute does run (each attention block's forward twice).
- **Refusals**, each against the JAX package's own: mixup and CutMix in
  the loss-watched and segmentation trainers, k steps per dispatch in the
  GAN trainers, both alphas at once.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.configs import get_config as jax_get_config
from deepvision_tpu.core import centernet as jax_centernet
from deepvision_tpu.core import detection as jax_detection
from deepvision_tpu.core import gan as jax_gan
from deepvision_tpu.core import pose as jax_pose
from deepvision_tpu.core import segment as jax_segment
from deepvision_tpu.core.steps import \
    make_classification_train_step as jax_make_train_step
from deepvision_tpu.core.train_state import TrainState as JaxTrainState
from deepvision_tpu.data.synthetic import \
    SyntheticClassification as JaxSynthetic
from deepvision_tpu.models.vit import ViT as JaxViT
from deepvision_tpu_torch.configs import get_config
from deepvision_tpu_torch.core import steps
from deepvision_tpu_torch.core.centernet import CenterNetTrainer
from deepvision_tpu_torch.core.config import OptimizerConfig, ScheduleConfig
from deepvision_tpu_torch.core.detection import DetectionTrainer
from deepvision_tpu_torch.core.gan import CycleGANTrainer, DCGANTrainer
from deepvision_tpu_torch.core.optim import build_optimizer
from deepvision_tpu_torch.core.pose import PoseTrainer
from deepvision_tpu_torch.core.segment import SegmentationTrainer
from deepvision_tpu_torch.core.train_state import TrainState
from deepvision_tpu_torch.core.trainer import Trainer
from deepvision_tpu_torch.data import detection as det_data
from deepvision_tpu_torch.data import pose as pose_data
from deepvision_tpu_torch.data.segmentation import SyntheticSegmentation
from deepvision_tpu_torch.data.synthetic import SyntheticClassification
from deepvision_tpu_torch.models.vit import MultiHeadAttention, ViT
from deepvision_tpu_torch.utils.flax_convert import params_to_state_dict
from test_torch_classify import flax_vit_params

# The port's steps update their state in place and donate nothing;
# jaxlint resolves the step factories by name to the JAX package's
# donating ones.
# jaxlint: disable-file=DON001

TINY = dict(num_classes=10, patch_size=8, embed_dim=192, depth=2,
            num_heads=3, mlp_dim=768)
BATCH = 8
LR = 1e-2
ALPHAS = {"mixup": 0.2, "cutmix": 1.0}
LOSS_RTOL = 2e-5
NORM_RTOL = 1e-5
REMAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_draws(rng, step: int, batch: int, alpha: float,
              cutmix: bool) -> steps.MixDraws:
    """The draws the JAX classification step makes at `step` from `rng`
    (its `fold_in(step_rng, 1)` split in three)."""
    step_rng = jax.random.fold_in(rng, step)
    mix_rng, perm_rng, box_rng = jax.random.split(
        jax.random.fold_in(step_rng, 1), 3)
    perm = np.asarray(jax.random.permutation(perm_rng, batch))
    lam = float(jax.random.beta(mix_rng, alpha, alpha, dtype=jnp.float32))
    centre = (tuple(float(v) for v in jax.random.uniform(
        box_rng, (2,), dtype=jnp.float32)) if cutmix else None)
    return steps.MixDraws(lam, perm, centre)


@pytest.fixture(scope="module", params=sorted(ALPHAS))
def mixed(request):
    """Two steps of each package under mixup or CutMix, with the gradient
    norm logged; the JAX step compiled once per mode."""
    torch.set_num_threads(1)
    mode = request.param
    alpha, cutmix = ALPHAS[mode], mode == "cutmix"
    batches = list(JaxSynthetic(BATCH, 32, 3, 10, 2, seed=5))
    jax_model = JaxViT(**TINY, attention_impl="naive", dtype=jnp.float32)
    params = flax_vit_params(jax_model, batches[0][0], seed=2)
    tx = optax.sgd(LR)
    state = JaxTrainState.create(jax_model.apply, params, tx)
    kw = {f"{mode}_alpha": alpha}
    jstep = jax_make_train_step(compute_dtype=jnp.float32, donate=False,
                                log_grad_norm=True, **kw)
    rng = jax.random.PRNGKey(7)
    want = []
    for images, labels in batches:
        state, m = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                         rng)
        want.append({k: float(v) for k, v in m.items()})

    model = ViT(**TINY, dtype=torch.float32, image_size=32)
    model.load_state_dict(params_to_state_dict(params, model))
    opt = build_optimizer(model.parameters(),
                          OptimizerConfig(name="sgd", learning_rate=LR,
                                          momentum=0.0),
                          ScheduleConfig(), 10, 1)
    port_state = TrainState(model, opt)
    pstep = steps.make_classification_train_step(
        compute_dtype=torch.float32, log_grad_norm=True,
        draw=lambda st, b: jax_draws(rng, st.step, b, alpha, cutmix), **kw)
    got = []
    for images, labels in batches:
        m = pstep(port_state, torch.from_numpy(images),
                  torch.from_numpy(labels))
        got.append({k: float(v) for k, v in m.items()})
    return {"want": want, "got": got, "mode": mode}


@pytest.mark.parametrize("step", [0, 1])
def test_mixed_loss_and_topk_match_the_jax_step_on_its_draws(mixed, step):
    want, got = mixed["want"][step], mixed["got"][step]
    assert set(got) == set(want) == {"loss", "top1", "top5", "grad_norm"}
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])


@pytest.mark.parametrize("step", [0, 1])
def test_grad_norm_matches_the_jax_step(mixed, step):
    want, got = mixed["want"][step], mixed["got"][step]
    assert got["grad_norm"] > 0
    assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                             rel=NORM_RTOL)


@pytest.mark.parametrize("shapes", [[(3,)], [(4, 5), (5,), (2, 3, 3, 8)],
                                    [(1,), (1000,), (7, 7)]])
def test_maybe_grad_norm_is_optax_global_norm(shapes):
    rs = np.random.RandomState(len(shapes))
    arrays = [(rs.randn(*s) * 10 ** rs.uniform(-3, 3)).astype(np.float32)
              for s in shapes]
    params = []
    for a in arrays:
        p = torch.nn.Parameter(torch.zeros(a.shape))
        p.grad = torch.from_numpy(a)
        params.append(p)
    params.append(torch.nn.Parameter(torch.zeros(2)))   # no gradient
    got = steps.maybe_grad_norm(True, params)["grad_norm"]
    want = optax.global_norm([jnp.asarray(a) for a in arrays])
    assert float(got) == pytest.approx(float(want), rel=NORM_RTOL)
    assert steps.maybe_grad_norm(False, params) == {}


def _jax_in_box(lam0: float, centre, h: int, w: int):
    """The JAX step's CutMix box and lam, its own arithmetic."""
    lam0 = jnp.float32(lam0)
    r = jnp.sqrt(1.0 - lam0)
    cy, cx = (jnp.float32(c) for c in centre)
    y1 = jnp.clip((cy - r / 2) * h, 0, h)
    y2 = jnp.clip((cy + r / 2) * h, 0, h)
    x1 = jnp.clip((cx - r / 2) * w, 0, w)
    x2 = jnp.clip((cx + r / 2) * w, 0, w)
    rows = jnp.arange(h, dtype=jnp.float32)
    cols = jnp.arange(w, dtype=jnp.float32)
    in_box = (((rows >= y1) & (rows < y2))[:, None]
              & ((cols >= x1) & (cols < x2))[None, :])
    return np.asarray(in_box), float(1.0 - in_box.mean())


@pytest.mark.parametrize("case", range(12))
def test_cutmix_box_and_lam_are_the_jax_steps(case):
    rs = np.random.RandomState(case)
    lam0 = [0.0, 1e-7, 0.5, 0.9999][case % 4] if case < 4 else rs.rand()
    centre = (rs.rand(), rs.rand()) if case % 3 else (0.0, 0.999)
    h, w = [(32, 32), (224, 224), (17, 40)][case % 3]
    draws = steps.MixDraws(float(np.float32(lam0)), np.arange(2),
                           tuple(float(np.float32(c)) for c in centre))
    r0, r1, c0, c1, lam = steps.cutmix_box(draws, h, w)
    mask = np.zeros((h, w), bool)
    mask[r0:r1, c0:c1] = True
    want_mask, want_lam = _jax_in_box(draws.lam, draws.centre, h, w)
    np.testing.assert_array_equal(mask, want_mask)
    assert lam == want_lam


def test_apply_cutmix_pastes_the_permuted_box_and_leaves_its_input():
    x = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
    before = x.clone()
    draws = steps.MixDraws(0.75, np.array([1, 0]), (0.5, 0.5))
    out, lam = steps.apply_cutmix(x, draws)
    r0, r1, c0, c1, _ = steps.cutmix_box(draws, 8, 8)
    torch.testing.assert_close(x, before, rtol=0, atol=0)
    torch.testing.assert_close(out[0, r0:r1, c0:c1], x[1, r0:r1, c0:c1])
    out[:, r0:r1, c0:c1] = x[:, r0:r1, c0:c1]
    torch.testing.assert_close(out, x, rtol=0, atol=0)
    assert lam == 1.0 - (r1 - r0) * (c1 - c0) / 64


def test_the_mix_draws_repeat_per_seed_and_step_on_their_own_stream():
    state = TrainState(torch.nn.Linear(2, 2), None, step=3, seed=1)

    def draws(stream="mix"):
        return steps.draw_mix(state.step_numpy_rng(stream), 16, 0.4, True)

    a, b = draws(), draws()
    assert (a.lam, a.centre) == (b.lam, b.centre)
    np.testing.assert_array_equal(a.perm, b.perm)
    assert sorted(a.perm) == list(range(16)) and 0 < a.lam < 1
    other = draws("augment")
    state.step = 4
    later = draws()
    assert a.lam not in (other.lam, later.lam)


def test_mixup_and_cutmix_are_exclusive_as_in_jax():
    with pytest.raises(ValueError) as want:
        jax_make_train_step(mixup_alpha=0.2, cutmix_alpha=1.0)
    with pytest.raises(ValueError) as got:
        steps.make_classification_train_step(mixup_alpha=0.2,
                                             cutmix_alpha=1.0)
    assert str(got.value) == str(want.value)


# -- remat -------------------------------------------------------------------

def _cfg(name: str, size: int, **over):
    cfg = get_config(name)
    return cfg.replace(dtype="float32", batch_size=2, **over,
                       data=dataclasses.replace(cfg.data, image_size=size))


def _remat_case(name: str, workdir: str):
    """(trainer, batch) of one small model of each family."""
    if name == "vit":
        cfg = _cfg("vit_tiny", 32, model_kwargs={
            **get_config("vit_tiny").model_kwargs, "depth": 2,
            "dropout_rate": 0.1})
        batch = next(iter(SyntheticClassification(2, 32, 3, 10, 1, seed=0)))
        return Trainer(cfg, device="cpu", workdir=workdir), batch
    if name == "resnet":
        cfg = _cfg("resnet50_tpu", 32, ema_decay=None,
                   model_kwargs={"stage_sizes": (1, 1, 1, 1)})
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_classes=10))
        batch = next(iter(SyntheticClassification(2, 32, 3, 10, 1, seed=0)))
        return Trainer(cfg, device="cpu", workdir=workdir), batch
    if name in ("yolov3", "centernet"):
        size = 64
        cfg = (_cfg("yolov3_digits", size) if name == "yolov3"
               else _cfg("centernet_digits", size))
        batch = next(det_data.synthetic_batches(
            batch_size=2, image_size=size,
            num_classes=cfg.data.num_classes, steps=1, seed=0))
        cls = DetectionTrainer if name == "yolov3" else CenterNetTrainer
        return cls(cfg, device="cpu", workdir=workdir), batch
    if name == "pose":
        cfg = _cfg("hourglass104", 32, model_kwargs=dict(
            num_stack=2, order=2, width_mult=1 / 16))
        batch = next(pose_data.synthetic_batches(batch_size=2,
                                                 image_size=32, steps=1))
        return PoseTrainer(cfg, device="cpu", workdir=workdir), batch
    cfg = _cfg("unet_synthetic", 32)
    batch = next(iter(SyntheticSegmentation(
        2, 32, 3, cfg.data.num_classes, 1, seed=0)))
    return SegmentationTrainer(cfg, device="cpu", workdir=workdir), batch


@pytest.mark.parametrize("name", ["vit", "resnet", "yolov3", "centernet",
                                  "pose", "unet"])
def test_remat_gives_the_gradients_and_statistics_of_no_remat(name,
                                                              tmp_path):
    trainer, batch = _remat_case(name, str(tmp_path))
    model0 = trainer.model
    opt_cfg = OptimizerConfig(name="sgd", learning_rate=0.0, momentum=0.0)
    calls = []
    runs = {}
    batch = tuple(torch.from_numpy(np.asarray(a)) for a in batch)
    for remat in (False, True):
        model = copy.deepcopy(model0)
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.register_forward_hook(lambda *a: calls.append(remat))
        state = TrainState(model, build_optimizer(
            model.parameters(), opt_cfg, ScheduleConfig(), 1, 1),
            seed=3, remat=remat)
        runs[remat] = (model, trainer.train_step(state, *batch))
    (plain, m0), (rem, m1) = runs[False], runs[True]
    assert m0["loss"].item() == pytest.approx(m1["loss"].item(),
                                              rel=REMAT_TOL)
    n_grads = 0
    for (n, p), q in zip(plain.named_parameters(), rem.parameters()):
        if p.grad is None:
            assert q.grad is None, n
            continue
        n_grads += 1
        scale = max(p.grad.abs().max().item(), 1e-30)
        assert (p.grad - q.grad).abs().max().item() <= REMAT_TOL * scale, n
    assert n_grads > 0
    buffers = dict(plain.named_buffers())
    stats = [n for n in buffers if "running" in n]
    assert (len(stats) > 0) == (name != "vit")
    for n, b in rem.named_buffers():
        torch.testing.assert_close(b, buffers[n], rtol=REMAT_TOL, atol=0,
                                   msg=n)
    if name == "vit":
        # each block's attention ran again in the recompute
        assert calls.count(False) == 2 and calls.count(True) == 4


# -- refusals ------------------------------------------------------------------

@pytest.mark.parametrize("lever", ["mixup_alpha", "cutmix_alpha"])
@pytest.mark.parametrize("name,ours,theirs", [
    ("yolov3_digits", DetectionTrainer, jax_detection.DetectionTrainer),
    ("centernet_digits", CenterNetTrainer, jax_centernet.CenterNetTrainer),
    ("hourglass104", PoseTrainer, jax_pose.PoseTrainer),
    ("unet_synthetic", SegmentationTrainer,
     jax_segment.SegmentationTrainer)])
def test_mixing_is_refused_outside_classification_as_in_jax(
        name, ours, theirs, lever, tmp_path):
    with pytest.raises(ValueError) as want:
        theirs(jax_get_config(name).replace(**{lever: 0.2}),
               workdir=str(tmp_path / "jax"))
    with pytest.raises(ValueError) as got:
        ours(get_config(name).replace(**{lever: 0.2}), device="cpu",
             workdir=str(tmp_path / "port"))
    assert str(got.value) == str(want.value)
    assert "classification-only" in str(got.value)


@pytest.mark.parametrize("name,ours", [("dcgan", DCGANTrainer),
                                       ("cyclegan", CycleGANTrainer)])
def test_gans_refuse_k_steps_per_dispatch_as_in_jax(name, ours, tmp_path):
    with pytest.raises(ValueError) as want:
        jax_gan.AdversarialTrainer._validate_config(
            jax_get_config(name).replace(steps_per_dispatch=2))
    with pytest.raises(ValueError) as got:
        ours(get_config(name).replace(steps_per_dispatch=2),
             workdir=str(tmp_path), device="cpu")
    assert type(got.value) is type(want.value)
    assert "steps_per_dispatch > 1 is not supported by adversarial" in str(
        got.value)
