"""The experiment runner: training, periodic evaluation, checkpoints, the
post-training reconstruction and the stages after it (counterpart of
``camels_diffusion_model_tpu/cli/experiment.py``).

    python -m camels_diffusion_model_tpu_torch.cli.experiment <mode> <lr> <epochs> <timesteps> [n]

``mode`` is one of ``config.MODES`` and the positional arguments are those
of the reference script it stands for (``config.config_from_argv``).  It
runs on the CUDA card inside ``fp32_math`` (TF32 off); :func:`run_experiment`
takes ``device="cpu"`` for tests.  ``ExperimentConfig.dtype`` is the model's
compute dtype, ``"float32"`` (the CLI's) or ``"bfloat16"``, as in the JAX
runner (``experiment.py:158,199``): training, validation, the likelihood
passes and every sampler then compute in bf16 with fp32 parameters, Adam
state, loss and sampler state.

What runs, in the JAX runner's order and with its artifact names, log
lines, ``results`` keys and batching: the data (the ``.npy`` maps, or the
synthetic stand-ins when they are absent, ``data_source: "synthetic"``);
the model of the mode's variant (canonical, deep or big); the eval-image
selection; the epoch loop over wrap-padded, masked batches staged on the
card (``data.prefetch``); the periodic validation MSE (a no-grad forward:
kernels K2 and K3), the per-batch ELBO and the eval-point ELBO/BPD/NLL of
the mode; the weights files and ``weights/train_state.msgpack`` on their
cadence, and ``resume``; the BatchNorm fold, the reconstruction (the exact
chain: kernels K1, K2 and K3; ``main`` samples from pure noise instead), its
ELBO/BPD/NLL and the pixel-PDF statistics; then the recon P(k) with its
nan-safe ratio line, the mean correction (``means.txt``,
``corrected_means.txt``), the parameter grid, the guidance sweep (w <= 0
alone, every w > 0 in one call with a per-sample w) and the sensitivity
rows (one sampler call for all of them), each with its post metrics.

``shortcut="stochastic"`` builds the reference's model with a fresh
random init_conv projection a forward; every phase draws it from that
phase's generator, after its other draws (the trainer's ``(seed, 0,
step)``, the validation pass's, the likelihood passes' and the samplers'
below), and the folded inference copy keeps the mode (``load_model`` reads
it from the tree, which has no shortcut leaves).  The JAX runner seeds the
model's ``"shortcut"`` stream for ``init`` with ``fold_in(init_key, 1)``
(``experiment.py:200-206``); that draw touches no parameter, and the
port's init takes none.

What waits: the port writes no figure (no PNG; the run figures of
``utils/viz.py`` are not ported).  A run prints that it skipped them and
lists them in ``results["not_ported"]``.  ``mesh_devices > 1``, which
would change what the run computes, raises ``NotImplementedError``.

Noise comes from torch generators seeded by the run seed (the training
step's from ``(seed, 0, step)``, the validation pass's from ``(seed, 1,
epoch)``, the reconstruction's from ``(seed, 2)``, the parameter grid's,
the guidance sweep's and the sensitivity's from ``(seed, 3)``, ``(seed, 4)``
and ``(seed, 5)``), so the values differ from the JAX runner's; the data,
the split, the selected images, the batch order and the stages' contexts
and guidance weights are the same.  A resumed run shuffles its epochs as
the unbroken run did (the shuffles of the epochs done are drawn again
first).

Also :func:`sample_metrics` (``_sample_metrics``, ``experiment.py:103-115``)
and :func:`reconstruct` (``experiment.py:609-630``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import fp32_math, resolve_device
from ..config import ExperimentConfig, config_from_argv
from ..data.pipeline import batch_iterator, load_camels_dataset, num_batches
from ..data.prefetch import device_prefetch
from ..data.synthetic import synthetic_camels
from ..diffusion.likelihood import (
    NoiseFn,
    calculate_elbo_and_bpd,
    calculate_likelihood,
    elbo_bpd_batch,
    elbo_per_batch,
    nll_batch,
)
from ..diffusion.sampler import SamplerOutput, ZFn, sample_ddpm, sample_ddpm_from_noise
from ..diffusion.schedule import DDPMSchedule, NoiseScaling, make_schedule, q_sample
from ..models.blocks import SHORTCUTS
from ..models.context_unet import ContextUnet
from ..ops.spectrum import compare_power_spectra_stats
from ..ops.stats import compare_pdf_stats
from ..serving import load_model
from ..training.checkpoints import (
    load_train_checkpoint,
    save_model_weights,
    save_train_checkpoint,
    weights_checkpoint_plan,
)
from ..training.trainer import (
    create_train_state,
    make_eval_step,
    make_train_step,
    parse_remat_env,
    seeded_generator,
)
from ..utils.run_logging import RunLogger
from ..utils.weights import to_jax_variables


def sample_metrics(model, schedule: DDPMSchedule, x, c, generator,
                   batch_size: int, dims: Optional[int] = None,
                   elbo_noise_fn: Optional[NoiseFn] = None,
                   nll_noise_fn: Optional[NoiseFn] = None,
                   device=None) -> tuple:
    """``(elbo, bpd, nll)`` of maps ``x`` (NHWC) on contexts ``c``, in
    ordered batches of ``batch_size``; the ELBO pass draws its noise from
    ``generator`` first, then the NLL sweep (or each from its noise_fn)."""
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    c = c.cpu().numpy() if torch.is_tensor(c) else np.asarray(c)
    batches = list(batch_iterator(x, c, batch_size, shuffle=False))
    elbo, bpd = calculate_elbo_and_bpd(
        model, schedule, batches, generator, dims=dims, batch_size=batch_size,
        noise_fn=elbo_noise_fn, device=device)
    nll = calculate_likelihood(model, schedule, batches, generator,
                               batch_size=batch_size, noise_fn=nll_noise_fn,
                               device=device)
    return elbo, bpd, nll


def reconstruct(model, schedule: DDPMSchedule, images, params, generator,
                scaling: NoiseScaling = NoiseScaling.REFERENCE,
                save_rate: int = 20, noise=None, z_fn: Optional[ZFn] = None,
                device=None) -> SamplerOutput:
    """Forward-diffuse ``images`` (NHWC) to ``t = T`` with ``noise`` (drawn
    from ``generator`` when None) and run ``sample_ddpm_from_noise`` from
    there on ``params`` (None: the zero context, as for an unconditional
    experiment)."""
    device = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, device=device)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
    x_fwd = q_sample(schedule, images, schedule.timesteps, noise, scaling)
    return sample_ddpm_from_noise(model, schedule, generator, x_fwd, params=params,
                                  save_rate=save_rate, device=device, z_fn=z_fn)


def _load_raw_data(cfg: ExperimentConfig):
    """The real ``.npy`` inputs, or the synthetic stand-ins
    (``experiment.py:71-95``)."""
    if os.path.exists(cfg.maps_path) and os.path.exists(cfg.params_path):
        maps, params, source = np.load(cfg.maps_path), np.load(cfg.params_path), "real"
    elif cfg.synthetic_fallback:
        maps, params = synthetic_camels(n_param_sets=cfg.synthetic_param_sets,
                                        maps_per_set=15, size=cfg.data_size, seed=cfg.seed)
        source = "synthetic"
    else:
        raise FileNotFoundError(f"data files not found: {cfg.maps_path} / {cfg.params_path}")
    if cfg.max_maps is not None and maps.shape[0] > cfg.max_maps:
        n_sets = max(1, cfg.max_maps // 15)
        maps, params = maps[: n_sets * 15], params[:n_sets]
    return maps, params, source


def _subset_batches(x, c, n, batch_size, rng):
    """A random subset in ordered batches (``experiment.py:98-101``)."""
    idx = rng.choice(x.shape[0], size=min(n, x.shape[0]), replace=False)
    return list(batch_iterator(x[idx], c[idx], batch_size, shuffle=False))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unported(cfg: ExperimentConfig) -> List[str]:
    """The parts of ``cfg``'s run that this package does not do yet, which
    :func:`run_experiment` skips; raises ``NotImplementedError`` for options
    that would change what the run computes (module docstring), and
    ``ValueError`` for a dtype or shortcut mode neither package knows."""
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype={cfg.dtype!r}: 'float32' or 'bfloat16'")
    if cfg.shortcut not in SHORTCUTS:
        raise ValueError(f"unknown shortcut mode: {cfg.shortcut!r}")
    if cfg.mesh_devices is not None and cfg.mesh_devices > 1:
        raise NotImplementedError(f"mesh_devices={cfg.mesh_devices}: the port runs on "
                                  "one card (ROADMAP section 1, multi-device)")
    return ["figures"]


def _build_grid_params(cfg: ExperimentConfig, selected_params: np.ndarray) -> np.ndarray:
    """A 5x5 grid over the first two parameters, or 25 values of the first
    (``experiment.py:889-908``), around the first selected context."""
    axis = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    if cfg.num_params >= 2:
        pairs = [(a, b) for a in axis for b in axis]
    else:
        pairs = [(a,) for a in np.linspace(0.0, 1.0, 25, dtype=np.float32)]
    rows = []
    for values in pairs:
        row = selected_params[0].copy()
        row[:len(values)] = values
        rows.append(row)
    return np.stack(rows)


SENSITIVITY_VALUES = np.linspace(0.0, 1.0, 5, dtype=np.float32)


def _sensitivity_params(cfg: ExperimentConfig, selected_params: np.ndarray) -> np.ndarray:
    """``(num_params * 5, n_cfeat)``: the first selected context with one
    parameter at a time set to each of ``SENSITIVITY_VALUES``
    (``experiment.py:821-829``)."""
    rows = []
    for p_idx in range(cfg.num_params):
        for v in SENSITIVITY_VALUES:
            row = selected_params[0].copy()
            row[p_idx] = v
            rows.append(row)
    return np.stack(rows)


def guidance_sweep(model, schedule: DDPMSchedule, base: np.ndarray, strengths,
                   generator, size: int, device=None) -> Dict[float, np.ndarray]:
    """The maps of each guidance strength on the contexts ``base`` (5
    rows): each ``w <= 0`` in a call of its own (the single-forward
    semantics), every ``w > 0`` together in one call with a per-sample w
    (``experiment.py:771-806``)."""
    by_w: Dict[float, np.ndarray] = {}
    n = len(base)
    for w in [w for w in strengths if w <= 0]:
        by_w[w] = sample_ddpm(model, schedule, generator, n_sample=n, size=size,
                              params=base, guide_w=w, device=device).cpu().numpy()
    pos = [w for w in strengths if w > 0]
    if pos:
        x = sample_ddpm(model, schedule, generator, n_sample=n * len(pos), size=size,
                        params=np.tile(base, (len(pos), 1)),
                        guide_w=np.repeat(np.asarray(pos, np.float32), n),
                        device=device).cpu().numpy()
        for i, w in enumerate(pos):
            by_w[w] = x[i * n:(i + 1) * n]
    return by_w


def run_experiment(cfg: ExperimentConfig, *, device=None) -> Dict[str, object]:
    """Train and evaluate as ``cfg`` says (module docstring); returns the
    JAX runner's ``results`` keys for the parts run, ``"pdf_stats"`` (the
    pixel-PDF comparison its figure would plot) and ``"not_ported"``, the
    parts skipped."""
    not_ported = _unported(cfg)
    device = resolve_device(device)
    with fp32_math():
        return _run(cfg, device, not_ported)


def _run(cfg: ExperimentConfig, device: torch.device, not_ported: List[str]) -> dict:
    spec = cfg.spec
    output_dir = cfg.output_dir()
    save_dir = os.path.join(output_dir, "weights")
    os.makedirs(save_dir, exist_ok=True)
    logger = RunLogger(output_dir, device)
    if spec.timing_log:
        logger.write_header(cfg.lrate, cfg.n_epoch, cfg.timesteps, None if not spec.conditional
                            else (cfg.param_index if spec.param_index_mode else cfg.num_params))
    schedule = make_schedule(cfg.timesteps, cfg.beta1, cfg.beta2)
    on_device = DDPMSchedule(*(a.to(device) for a in schedule[:3]), schedule.timesteps)

    # ---- data (experiment.py:157-187) ------------------------------------
    raw_maps, raw_params, data_source = _load_raw_data(cfg)
    ds = load_camels_dataset(
        raw_maps, raw_params, num_params=cfg.num_params, height=cfg.height,
        test_size=min(cfg.test_size, max(raw_maps.shape[0] // 10, 1)), seed=cfg.seed,
        style=spec.data_style, param_index=cfg.param_index if spec.param_index_mode else None,
    )
    del raw_maps
    if spec.conditional:
        train_c, test_c = ds.train_c, ds.test_c
        np.save(os.path.join(output_dir, "param_min.npy"), ds.param_min)
        np.save(os.path.join(output_dir, "param_max.npy"), ds.param_max)
        if spec.param_index_mode:
            np.save(os.path.join(output_dir, "param_index.npy"), cfg.param_index)
        logger.dataset_info(ds.info)
    else:  # a zero context of the model's width (train_diffusion.py:147)
        train_c = np.zeros((ds.n_train, cfg.n_cfeat), np.float32)
        test_c = np.zeros((ds.n_test, cfg.n_cfeat), np.float32)

    # ---- model, optimizer, steps (experiment.py:189-237) ------------------
    factory = getattr(ContextUnet, spec.model_variant)  # canonical, deep or big
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = factory(n_cfeat=cfg.n_cfeat, n_feat=cfg.n_feat, height=cfg.height,
                        dtype=DTYPES[cfg.dtype], shortcut=cfg.shortcut)
    model = model.to(device=device, memory_format=torch.channels_last)
    steps_per_epoch = num_batches(ds.n_train, cfg.batch_size)
    state = create_train_state(model, cfg.lrate, cfg.n_epoch, steps_per_epoch, seed=cfg.seed)
    try:
        remat = parse_remat_env(os.environ.get("CAMELS_TRAIN_REMAT", ""))
    except ValueError as e:
        raise SystemExit(f"CAMELS_TRAIN_REMAT: {e}")
    step_args = (cfg.timesteps, spec.q_scaling, cfg.beta1, cfg.beta2)
    train_step = make_train_step(model, *step_args, remat=remat)
    eval_step = make_eval_step(model, *step_args)

    def pad(bx, bc):
        """Wrap-pad a partial batch to ``batch_size`` rows and mask the pad
        rows (``experiment.py:259-286``): one shape for every step."""
        n = bx.shape[0]
        if n < cfg.batch_size:
            idx = np.arange(cfg.batch_size) % n
            bx, bc = bx[idx], bc[idx]
        return bx, bc, (np.arange(cfg.batch_size) < n).astype(np.float32)

    start_epoch = 0
    ckpt_path = os.path.join(save_dir, "train_state.msgpack")
    if cfg.resume and os.path.exists(ckpt_path):
        state, start_epoch, _ = load_train_checkpoint(state, ckpt_path)
        print(f"Resumed from epoch {start_epoch}")

    # ---- eval image selection (experiment.py:299-318) ---------------------
    sel_rng = np.random.default_rng(cfg.seed + 1)
    if spec.conditional:
        sel_idx = sel_rng.choice(ds.n_test, size=min(cfg.n_eval_images, ds.n_test),
                                 replace=False)
        selected_images, selected_params = ds.test_x[sel_idx], ds.test_c[sel_idx]
        logger.selected_params(selected_params)
    else:
        all_x = np.concatenate([ds.train_x, ds.test_x])
        sel_idx = sel_rng.choice(all_x.shape[0], size=cfg.n_eval_images, replace=False)
        selected_images = all_x[sel_idx]
        selected_params = np.zeros((cfg.n_eval_images, cfg.n_cfeat), np.float32)
    processed_images_mean = float(selected_images.mean())

    # ---- training loop (experiment.py:320-420) ----------------------------
    loss_log: List[float] = []
    val_loss_log: List[float] = []
    likelihood_log: List[float] = []
    val_likelihood_log: List[float] = []
    elbo_log: List[float] = []
    bpd_log: List[float] = []
    val_elbo_log: List[float] = []
    val_bpd_log: List[float] = []
    epoch_times: List[float] = []
    epoch_rng = np.random.default_rng(cfg.seed + 2)
    for _ in range(start_epoch):  # the shuffles of the epochs already done
        epoch_rng.shuffle(np.arange(ds.n_train))
    eval_np_rng = np.random.default_rng(cfg.seed + 3)
    dims = cfg.height * cfg.height
    ln2 = np.log(2.0)

    def folded():
        """The BatchNorm-folded inference copy of the model in its dtype
        (the JAX runner's ``fold_inference``)."""
        return load_model(to_jax_variables(model.state_dict()), device, dtype=model.dtype)

    training_start = time.time()
    for ep in range(start_epoch, cfg.n_epoch):
        ep_start = time.time()
        logger.device_line()
        loss_acc = torch.zeros((), device=device)
        elbo_acc = torch.zeros((), device=device)
        n_b = 0
        staged = device_prefetch(
            batch_iterator(ds.train_x, train_c, cfg.batch_size, rng=epoch_rng),
            device, transform=lambda item: pad(*item))
        for bx, bc, bmask in staged:
            metrics = train_step(state, bx, bc, bmask)
            loss_acc += metrics["loss"]
            if spec.per_batch_elbo:
                elbo_acc += elbo_per_batch(on_device, metrics["per_sample_mse"],
                                           metrics["t"], bmask)
            n_b += 1
        epoch_loss = float(loss_acc) / n_b
        epoch_elbo = float(elbo_acc)
        epoch_bpd = epoch_elbo / (dims * ln2)
        loss_log.append(epoch_loss)
        epoch_times.append(time.time() - ep_start)
        if spec.timing_log:
            if spec.per_batch_elbo:
                logger.append(
                    f"Epoch {ep + 1}/{cfg.n_epoch} completed in {epoch_times[-1]:.2f} seconds\n"
                    f"  Training Loss: {epoch_loss:.6f}, ELBO: {epoch_elbo / n_b:.6f}, "
                    f"BPD: {epoch_bpd / n_b:.6f}\n")
            else:
                logger.epoch(ep, cfg.n_epoch, epoch_times[-1], epoch_loss)
        if spec.per_batch_elbo:
            elbo_log.append(epoch_elbo / n_b)
            bpd_log.append(epoch_bpd / n_b)

        # ---- periodic eval (experiment.py:391-535) ------------------------
        if spec.track_val_mse and (ep % cfg.eval_every == 0 or ep == cfg.n_epoch - 1):
            generator = seeded_generator(device, cfg.seed, 1, ep)
            vloss_acc = torch.zeros((), device=device)
            velbo_acc = torch.zeros((), device=device)
            v_b = 0
            for bx, bc in batch_iterator(ds.test_x, test_c, cfg.batch_size, shuffle=False):
                bx, bc, bmask = pad(bx, bc)
                em = eval_step(bx, bc, bmask, generator=generator)
                vloss_acc += em["loss"]
                if spec.per_batch_elbo:
                    velbo_acc += elbo_per_batch(on_device, em["per_sample_mse"], em["t"],
                                                torch.as_tensor(bmask, device=device))
                v_b += 1
            val_loss = float(vloss_acc) / max(v_b, 1)
            val_loss_log.append(val_loss)

            train_elbo = train_bpd = val_elbo = val_bpd = None
            train_nll = val_nll = None
            nll_seconds = 0.0
            inf_model = folded() if (spec.per_batch_elbo or spec.eval_elbo
                                     or spec.eval_nll) else None
            eb = cfg.eval_batch_size

            def nll_of(x, c):
                return calculate_likelihood(
                    inf_model, schedule, _subset_batches(x, c, cfg.nll_subset, eb, eval_np_rng),
                    generator, batch_size=eb, device=device)

            if spec.per_batch_elbo:
                val_elbo = float(velbo_acc) / max(v_b, 1)
                val_bpd = val_elbo / (dims * ln2)
                val_elbo_log.append(val_elbo)
                val_bpd_log.append(val_bpd)
                nll_start = time.time()
                val_nll = nll_of(ds.test_x, test_c)
                val_likelihood_log.append(val_nll)
                nll_seconds = time.time() - nll_start
            if spec.eval_elbo and not spec.per_batch_elbo:
                train_elbo, train_bpd = calculate_elbo_and_bpd(
                    inf_model, schedule,
                    _subset_batches(ds.train_x, train_c, cfg.elbo_subset, eb, eval_np_rng),
                    generator, dims=dims, batch_size=eb, device=device)
                val_elbo, val_bpd = calculate_elbo_and_bpd(
                    inf_model, schedule, list(batch_iterator(ds.test_x, test_c, eb, shuffle=False)),
                    generator, dims=dims, batch_size=eb, device=device)
                elbo_log.append(train_elbo)
                bpd_log.append(train_bpd)
                val_elbo_log.append(val_elbo)
                val_bpd_log.append(val_bpd)
            if spec.eval_nll:
                nll_start = time.time()
                if not spec.val_nll_only:
                    train_nll = nll_of(ds.train_x, train_c)
                    likelihood_log.append(train_nll)
                val_nll = nll_of(ds.test_x, test_c)
                val_likelihood_log.append(val_nll)
                nll_seconds = time.time() - nll_start

            if spec.timing_log:
                if spec.per_batch_elbo:
                    logger.append(
                        f"  Validation Loss: {val_loss:.6f}, "
                        f"Val ELBO: {val_elbo:.6f}, Val BPD: {val_bpd:.6f}\n"
                        f"  Negative Log Likelihood: {val_nll:.6f}\n"
                        f"  Likelihood calculation took {nll_seconds:.2f} seconds\n")
                elif spec.eval_elbo and spec.eval_nll:
                    logger.eval_metrics(
                        val_loss, train_elbo or 0.0, train_bpd or 0.0, val_elbo or 0.0,
                        val_bpd or 0.0, train_nll if train_nll is not None else 0.0,
                        val_nll if val_nll is not None else 0.0, nll_seconds)
                elif spec.eval_nll:
                    logger.append(
                        f"  Validation Loss: {val_loss:.6f}\n"
                        + (f"  Train Negative Log Likelihood: {train_nll:.6f}\n"
                           if train_nll is not None else "")
                        + f"  Val Negative Log Likelihood: {val_nll:.6f}\n"
                        f"  Likelihood calculation took {nll_seconds:.2f} seconds\n")
                else:
                    logger.append(f"  Validation Loss: {val_loss:.6f}\n")
            print(f"Epoch {ep + 1}/{cfg.n_epoch}, Train Loss: {epoch_loss:.6f}, "
                  f"Val Loss: {val_loss:.6f}")

        # ---- checkpoints (experiment.py:537-554) --------------------------
        save_weights, ckpt_name = weights_checkpoint_plan(spec.ckpt_style, ep, cfg.n_epoch,
                                                          cfg.ckpt_every)
        if save_weights:
            save_model_weights(model, os.path.join(save_dir, ckpt_name))
        if (ep + 1) % cfg.ckpt_every == 0 or ep == cfg.n_epoch - 1:
            save_train_checkpoint(state, ep + 1, ckpt_path)

    total_training_time = time.time() - training_start
    inf_model = folded()
    if spec.timing_log:
        logger.training_complete(
            total_training_time, epoch_times or [0.0], loss_log[-1] if loss_log else 0.0,
            val_loss_log[-1] if val_loss_log else None, bpd_log[-1] if bpd_log else None,
            val_bpd_log[-1] if val_bpd_log else None,
            likelihood_log[-1] if likelihood_log else None,
            val_likelihood_log[-1] if val_likelihood_log else None)
    results: Dict[str, object] = {
        "output_dir": output_dir,
        "data_source": data_source,
        "loss_log": loss_log,
        "val_loss_log": val_loss_log,
        "total_training_time": total_training_time,
        "epoch_times": epoch_times,
        "n_train": ds.n_train,
        "not_ported": not_ported,
    }

    # ---- reconstruction (experiment.py:600-665) ---------------------------
    # (main samples fresh maps from pure noise with a zero context instead)
    if spec.timing_log:
        logger.sampling_header()
    generator = seeded_generator(device, cfg.seed, 2)
    scaling = NoiseScaling(spec.q_scaling)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    if spec.pure_noise_sampling:
        recon_x = sample_ddpm(inf_model, schedule, generator, n_sample=cfg.n_eval_images,
                              size=cfg.height,
                              params=np.zeros((cfg.n_eval_images, cfg.n_cfeat), np.float32),
                              device=device).cpu().numpy()
    else:
        recon = reconstruct(inf_model, schedule, selected_images,
                            selected_params if spec.conditional else None, generator,
                            scaling=scaling, device=device)
        recon_x = recon.x.cpu().numpy()
    seconds = time.time() - t0
    if spec.timing_log:
        logger.reconstruction_perf(len(selected_images), seconds, seconds / cfg.timesteps,
                                   cfg.timesteps)
    if spec.post_metrics:
        r_elbo, r_bpd, r_nll = sample_metrics(inf_model, schedule, recon_x, selected_params,
                                              generator, cfg.batch_size, dims, device=device)
        logger.sample_metrics("reconstructed images", r_elbo, r_bpd, r_nll)
        results["recon_metrics"] = {"elbo": r_elbo, "bpd": r_bpd, "nll": r_nll}

    # ---- pixel-PDF comparison (experiment.py:667-677) ----------------------
    results["pdf_stats"] = compare_pdf_stats(selected_images[..., 0], recon_x[..., 0])
    reconstructed_mean = float(recon_x.mean())
    results["means"] = {"processed": processed_images_mean,
                        "reconstructed": reconstructed_mean}

    # ---- recon power spectra (experiment.py:679-715) -----------------------
    if spec.recon_power_spectra:
        k, om, _, gm, _ = compare_power_spectra_stats(selected_images[..., 0],
                                                      recon_x[..., 0])
        with np.errstate(divide="ignore", invalid="ignore"):
            pk_ratio = gm / om
        # The reference's mean takes in the 0/0 bins and logs nan; the
        # second line is over the populated bins.
        ratio_mean = float(np.mean(pk_ratio[1:]))
        ratio_std = float(np.std(pk_ratio[1:]))
        finite = np.isfinite(pk_ratio[1:])
        safe_mean = float(np.mean(pk_ratio[1:][finite])) if finite.any() else float("nan")
        safe_std = float(np.std(pk_ratio[1:][finite])) if finite.any() else float("nan")
        logger.append(
            "\nPower Spectrum Analysis:\n"
            f"  Mean P(k) ratio (generated/original): {ratio_mean:.4f} ± {ratio_std:.4f}\n"
            f"  Mean P(k) ratio over populated bins: {safe_mean:.4f} ± {safe_std:.4f}\n")
        good = np.where((pk_ratio > 0.8) & (pk_ratio < 1.2) & (k > 0))[0]
        if len(good) > 0:
            logger.append(f"  Good P(k) match (within 20%) for k range: "
                          f"[{k[good[0]]:.4f}, {k[good[-1]]:.4f}]\n")
        results["pk_ratio"] = {"mean": ratio_mean, "std": ratio_std,
                               "safe_mean": safe_mean, "safe_std": safe_std}

    # ---- mean-ratio correction (experiment.py:717-736) ---------------------
    if spec.mean_correction:
        with open(os.path.join(output_dir, "means.txt"), "w") as f:
            f.write(f"Processed Images Mean: {processed_images_mean}\n")
            f.write(f"Reconstructed Images Mean: {reconstructed_mean}\n")
        mean_ratio = processed_images_mean / reconstructed_mean
        corrected = recon_x * mean_ratio
        with open(os.path.join(output_dir, "corrected_means.txt"), "w") as f:
            f.write(f"Processed Images Mean: {processed_images_mean}\n")
            f.write(f"Corrected Reconstructed Images Mean: {float(corrected.mean())}\n")
        results["mean_ratio"] = mean_ratio

    # ---- parameter grid (experiment.py:738-765) ----------------------------
    if spec.param_grid and spec.conditional:
        grid_params = _build_grid_params(cfg, selected_params)
        generator = seeded_generator(device, cfg.seed, 3)
        t0 = time.time()
        grid_x = sample_ddpm(inf_model, schedule, generator, n_sample=len(grid_params),
                             size=cfg.height, params=grid_params,
                             device=device).cpu().numpy()
        if spec.timing_log:
            logger.grid_perf(len(grid_params), time.time() - t0)
        if spec.post_metrics:
            g_elbo, g_bpd, g_nll = sample_metrics(inf_model, schedule, grid_x, grid_params,
                                                  generator, cfg.batch_size, dims,
                                                  device=device)
            logger.sample_metrics("parameter grid samples", g_elbo, g_bpd, g_nll)
            results["grid_metrics"] = {"elbo": g_elbo, "bpd": g_bpd, "nll": g_nll}

    # ---- guidance sweep (experiment.py:767-817) ----------------------------
    if spec.guidance_sweep and spec.conditional:
        base = np.tile(selected_params[0], (5, 1))
        generator = seeded_generator(device, cfg.seed, 4)
        guided_by_w = guidance_sweep(inf_model, schedule, base, cfg.guidance_strengths,
                                     generator, cfg.height, device)
        if spec.post_metrics:
            guided_metrics = []
            for w in cfg.guidance_strengths:
                e, b, nll = sample_metrics(inf_model, schedule, guided_by_w[w], base,
                                           generator, 5, dims, device=device)
                guided_metrics.append({"guidance": w, "elbo": e, "bpd": b, "nll": nll})
                logger.guidance_metrics(w, e, b, nll)
            results["guidance_metrics"] = guided_metrics

    # ---- sensitivity, one sampler call (experiment.py:819-875) -------------
    if spec.sensitivity and spec.conditional and cfg.num_params > 0:
        sens_params = _sensitivity_params(cfg, selected_params)
        generator = seeded_generator(device, cfg.seed, 5)
        sens_x = sample_ddpm(inf_model, schedule, generator, n_sample=len(sens_params),
                             size=cfg.height, params=sens_params, device=device)
        if spec.post_metrics:
            per_elbo = elbo_bpd_batch(inf_model, schedule, sens_x, sens_params, generator,
                                      device=device).cpu().numpy()
            per_nll = nll_batch(inf_model, schedule, sens_x, sens_params, generator,
                                device=device).cpu().numpy()
            for p_idx in range(cfg.num_params):
                logger.sensitivity_header(p_idx)
                for i, v in enumerate(SENSITIVITY_VALUES):
                    e = float(per_elbo[p_idx * 5 + i])
                    logger.sensitivity_value(float(v), e, e / (dims * np.log(2.0)),
                                             float(per_nll[p_idx * 5 + i]))

    print("Not run by the port (ROADMAP section 1, leftovers): " + ", ".join(not_ported))
    print("Training and evaluation completed"
          + (f" with {cfg.num_params} conditioning parameters." if spec.conditional else "."))
    return results


def main(argv=None) -> int:
    """``<mode> <lr> <epochs> <timesteps> [num_params | param_index]``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        raise SystemExit("usage: python -m camels_diffusion_model_tpu_torch.cli.experiment "
                         "<mode> <lr> <epochs> <timesteps> [n]")
    results = run_experiment(config_from_argv(argv[0], argv[1:]))
    print(f"outputs in {results['output_dir']} (data: {results['data_source']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
