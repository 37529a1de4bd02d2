#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and hold its kernels to account.

    python3 chip_smoke.py

Phases, each timed on its own line:

  (a) build the three CUDA kernels (one nvcc a source, all started
      together, ctypes), print each source's compile seconds and ptxas's
      registers, shared memory and spills of the bf16 designs of K1 and
      K2, K1 at several output channels and K2's sharded launches;
  (b) load the committed checkpoint through the port's own msgpack decoder,
      md5-checked, fold its BatchNorms and put it on the card;
  (c) hold each kernel against its plain PyTorch version at the shapes each
      main path gives it (max abs error, ms, plain ms, library ms; times
      with the data in device memory, not L2), the deep and big models'
      shapes included (K1 with their tanh, on the fp32 band kernel from
      width 128; K2 with leaky ReLU and GELU, the fp32 out_norm on the
      large-slice kernel; K3 at their widths; 10 maps, 32 for validation),
      the narrow bf16 kernels of K1 and K2 at the narrow bf16 models'
      shapes (n_feat 32 of phase (o), 96 and 160), K1's narrow item with
      a masked last block (n_feat 264 of phase (o), 40, 48, 8) and K2's
      wide layout (n_feat 264's heads, 280's out_norm) at 2 and 16 maps,
      the float kernel's bf16 instance of K2 at groups of 264 channels (no
      model's), and the widths past the earlier kernels' limits (no
      committed model's): K1's split launch at 6000 bf16 channels on 8x8
      maps and at 16 maps of 64x64 (bf16 4840, fp32 3056 channels), K2's
      statistics and apply launches on one card (fp32 out_norm
      (10,128,128,512), n_feat 1032's up0_norm with the FiLM epilogue at
      16 maps in both types) and K3 at pixels of over 1024 accesses (fp32
      (4,32,32,8192), bf16 8200 channels); K1 to several image channels
      (a model of several CMD fields): 2, 3, 4 and 13 output channels at
      the served w=2 shape in both types, and 2 and 13 at a split width
      (6000 channels on 8x8 maps);
  (d) one full-width forward against the JAX golden fixture, TF32 off, and
      four guided sampler steps on the card against the CPU;
  (e) certified serving (``cli.serve``) at w=2 and w=0, 16 maps each,
      calibrated, with P(k), on the first 16 of the certification's
      test-split contexts (``serving.certification_contexts``), the
      contexts of the exact-chain references;
  (f) the exact 1500-step DDPM at w=0 on 4 maps, on the first 4;
  (g) neither ``jax`` nor ``camels_diffusion_model_tpu`` was imported;
  (h) the certification's battery on the maps (e) served: the pooled pixel
      PDF and its TV distance to the exact-chain reference, and ELBO/BPD
      with a fixed generator beside the reference's (information: N=16);
      gate: the ELBO of 2 maps on the card vs the CPU, same noise;
  (i) the NLL sweep over all 1500 timesteps at batch 4 on the exact
      chain's maps of (f); gates: finite, and t = 1..8 on the card vs the
      CPU, same noise;
  (j) DDIM in its posterior mode, eta 0, 50 steps, w=2, 16 maps; gate: its
      last four steps on the card vs the CPU;
  (k) reconstruction: 4 served maps forward-diffused to t = T (reference
      scaling), then the exact chain from that noise with its saved
      intermediates; gate: their count;
  (l) training: one full-width train step at batch 32 (4 wrap-padded rows
      masked, injected t and noise) from the committed checkpoint's
      unfolded weights on the card against the CPU (loss, gradients,
      BatchNorm running statistics), and the same step on the card in
      float64 and without cuDNN as the witness for a leaf beyond 1e-4 (see
      ``TRAIN_REL``); the kernel path refusing a forward
      that needs gradients; 30 Adam steps on one fixed batch from a fresh
      init, the loss falling, no kernel launched; ms per step, steps/s,
      peak memory and the top device ops of a step; then
      ``run_experiment("nov26", 1e-4, 2 epochs, T 1500)`` on the synthetic
      data, and a run resumed from its epoch-1 train checkpoint against its
      epoch-2 state;
  (m) the deep (n_feat 128, n_cfeat 5) and big (n_feat 256, n_cfeat 10)
      models at 128x128 from a seeded init: the forward on the card against
      the CPU at batch 2, one train step at batch 2 under phase (l)'s gate
      and witness on pinned kinks (see ``kink_sides``), four exact-chain
      steps against the CPU under injected z, ten strided steps at 10 maps
      and an ELBO batch with their launch counts (the out_norm on K2's
      large-slice kernel and the step on K1's band kernel, each once a step,
      the out_norm also once a forward: ``variant_kinds``), and the train
      step at batch 32 without remat (ms, idle share, peak memory);
  (n) ``run_experiment`` of ``initial`` (deep) and ``main`` (big) at full
      width and of ``paper`` (the parameter grid, guidance sweep and
      sensitivity with their post metrics) on the synthetic data, cut to
      ``RUN_T`` timesteps, one epoch and ``RUN_MAPS`` maps (the deep and
      big runs' launch counts with ``variant_kinds``);
  (o) the bf16 compute path at full width, the committed checkpoint folded
      in bf16 (``load_model(..., dtype=torch.bfloat16)``): the forward
      against the JAX bf16 golden; both certified rows served in bf16 at 16
      maps (``serve(..., dtype=...)``) on the same noise as (e)'s fp32 maps,
      with maps/min, the largest map difference and each row's P(k)
      deviation beside fp32's; four strided steps and the battery's ELBO of
      2 maps on the card against the CPU; a bf16 train step at batch 32
      against the CPU with its time, idle share and peak memory;
      ``run_experiment("nov26", dtype="bfloat16")`` with its resume; and a
      narrow bf16 model (n_feat 32, seeded init), whose out_norm and
      out_conv2 take the narrow bf16 kernels, and a wide one (n_feat 264),
      whose heads take K2's wide layout and out_conv2 K1's masked narrow
      item: each one's forward and four strided w=2 steps on the card
      against the CPU, with no launch of a float kernel's bf16 instance.
      bf16
      gates are yardsticks: the card's bf16 within ``BF16_FACTOR`` x the
      distance of the reference's bf16 from its fp32;
  (p) the reference's own workflow at full width: the native C++ prep
      (``native/camels_prep.cpp``, built by the port) must load; its
      ``"code"`` prep of a synthetic 1500x256x256 stack timed against the
      numpy path, with their largest difference (gate: an ulp of 1.0); the
      committed checkpoint exported to a reference ``.pth`` and served by
      the comparison CLI (``cli.sample.generate_comparison_plot``: the
      exact 1500-step chain, w 0, 8 maps; wall time and maps/min); the
      ``.pth`` model's eps on the card against the ``.msgpack`` model with
      the threefry shortcut put in and against the CPU; the stochastic
      init_conv shortcut: four exact-chain steps and an ELBO batch on the
      card against the CPU under injected z and draws, and
      ``run_experiment("nov26", shortcut="stochastic")``, one epoch at T
      1500;
  (q) data parallelism, DPM-Solver++(2M) and ``CAMELS_PROFILE``: (q1)
      phase (l2)'s ``run_experiment("nov26", T 1500)`` with
      ``mesh_devices=1`` inside an NCCL group of one (a ``FileStore``), its
      train state against phase (l2)'s mesh-less run; (q2) two gloo ranks
      sharing the card (``parallel.launch.spawn``; NCCL refuses two ranks
      on one device): a full-width train step at batch 32 (16 a rank) and
      one of 30 maps padded to 32 with the mask, from the committed
      checkpoint, against the single-process card step under phase (l)'s
      gate, and the strided DDPM at w=2 (10 steps, 5 maps: 3 + 2 real rows)
      against one process, with each rank's launch counts; (q3)
      ``sample_dpm2m`` at full width, 25 steps at w=2 on 16 maps, fp32 and
      bf16, its first 4 maps against the CPU's (1 in bf16, under phase
      (o)'s yardstick), wall time, maps/min and P(k) as information; (q4)
      ``run_experiment("nov26")`` of two epochs at T 20 on 90 maps with
      ``CAMELS_PROFILE`` set: a Chrome trace of its second epoch holding
      CUDA kernels;
  (r) the spatial (data x space) mesh and int8: (r1) K2's sharded
      statistics and apply launches and K1's halo mode, fp32 and bf16,
      against their plain versions on half of the w=2 serving heads' maps
      (a 1x2 mesh's shard), of the deep model's out_norm (10 maps) and of
      n_feat 136's and 264's heads; K3 on a shard; the bf16 halo mode's
      narrow item at n_feat 32's half, and with a masked last block at
      n_feat 40's and 264's; the split launch's halo mode at the widths
      K1's halo kernels do not take (6000 channels); K2's statistics and
      apply launches where 16-byte packs straddle groups (n_feat 136's and
      264's halves, n_feat 1032's up0_norm); K1's halo mode to 2, 3, 4 and
      13 image channels on half of the served w=2 features; (r2)
      two gloo ranks sharing the card as a (1 data x 2 space) mesh on the
      committed checkpoint: ``sample_ddpm(spatial=True)`` at w=2 on 16 maps
      (the exact chain of a 10-step schedule) against one process, in fp32
      and in bf16 (phase (o)'s yardstick), one train
      step of (q2)'s batch of 32 under phase (l)'s gate against (q2)'s
      one-process step, and one folded forward of the deep model at full
      width (128x128, 2 maps) against one process, each rank's launch
      counts, ms a step and collectives a step; (r3) ``QuantConv`` (W8A8,
      int32 sums) on the card bit for bit against the CPU at the canonical
      model's widest 3x3 conv (``down2.block2.conv2``, 256 -> 256 at 32x32,
      32 maps), timed beside cuDNN's fp32 and bf16 conv of that shape;
  (s) a canonical model at n_feat 1032 (16x16 maps, seeded init) in fp32
      and folded in bf16, the width from which its up0_norm (258 channels
      a group) takes K2's statistics and apply launches on one card: the
      forward on 2 maps and four strided w=2 steps on the card against the
      CPU (fp32 within ``GOLDEN_TOL``; bf16 under phase (o)'s yardstick),
      with their launch counts (the pair at up0_norm, no split K1: its
      band kernels take 1032 channels);
  (t) canonical models of two and of 13 image channels (``in_channels``
      2 and 13, the CAMELS Multifield Dataset's fields; n_feat 128, 64x64,
      n_cfeat 6, seeded init: no committed model has several) in fp32 and
      folded in bf16: four strided w=2 steps (and at two channels four
      posterior DDIM steps) on 16 maps on the card against the CPU under
      injected z (fp32 within ``GOLDEN_TOL``, all 16; bf16 under phase
      (o)'s yardstick, the first 4, as phase (q3) holds its bf16 maps),
      each ``LAUNCHES_PER_STEP`` a step, K1 at several output channels
      (``.launches_cout[_bf16]``), in its output-stationary kernel where
      the route gives it (``.launches_os[_bf16]``: fp32, and bf16 at 13).

Each main path -- serving at w=2 and w=0, the exact chain, the battery's
ELBO at w=2 and w=0, the NLL sweep, posterior DDIM, reconstruction, the
training runs, the variants' samplers and ELBO batches, the three runs of
phase (n), the comparison CLI and the stochastic paths of phase (p), the
mesh paths and DPM-Solver++(2M) of phase (q), the spatial paths of phase
(r) in each rank, the n_feat 1032 models of phase (s), the models of
several image channels of phase (t) -- is driven with every
kernel's launch count set to 0 just before it and read just after, and
must show its expected counts: a sampler path
``LAUNCHES_PER_STEP`` a step and no conv to the image channels
(``out_conv2``, which the step kernel applies); a likelihood path
``LAUNCHES_PER_FORWARD`` a forward and one conv to the image channels each
(the JAX package runs ``out_conv2`` as an XLA conv there too;
DPM-Solver++(2M) runs its forwards as these do); a training forward no
launch and one such conv.  Each
kernel has an fp32 and a bf16 instance with launch
counts of their own: an fp32 path launches no bf16 instance and a bf16
path (phase o) no fp32 one.  TF32 is off throughout.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; without CUDA it exits 2 and runs nothing.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from camels_diffusion_model_tpu_torch import _msgpack
from camels_diffusion_model_tpu_torch.cli import experiment
from camels_diffusion_model_tpu_torch.cli import sample as sample_cli
from camels_diffusion_model_tpu_torch.cli.experiment import reconstruct
from camels_diffusion_model_tpu_torch.cli.serve import TIMESTEPS, serve
from camels_diffusion_model_tpu_torch.diffusion.ddim import ddim_timesteps, sample_ddim
from camels_diffusion_model_tpu_torch.diffusion.dpm_solver import sample_dpm2m
from camels_diffusion_model_tpu_torch.diffusion.likelihood import (
    calculate_elbo_and_bpd,
    elbo_bpd_batch,
    nll_batch,
)
from camels_diffusion_model_tpu_torch.config import ExperimentConfig
from camels_diffusion_model_tpu_torch.data import native_prep
from camels_diffusion_model_tpu_torch.data.pipeline import (
    normalize_maps,
    num_batches,
    resize_maps_np,
)
from camels_diffusion_model_tpu_torch.data.synthetic import synthetic_camels
from camels_diffusion_model_tpu_torch.diffusion.sampler import sample_ddpm, save_schedule
from camels_diffusion_model_tpu_torch.diffusion.schedule import (
    ddpm_coefficients,
    make_schedule,
    q_sample,
)
from camels_diffusion_model_tpu_torch.ops import _build
from camels_diffusion_model_tpu_torch.ops.film import film_plain, fused_film
from camels_diffusion_model_tpu_torch.ops.groupnorm import (
    fused_groupnorm_act,
    groupnorm_act_plain,
    groupnorm_apply,
    groupnorm_apply_plain,
    groupnorm_stats,
    groupnorm_stats_plain,
)
from camels_diffusion_model_tpu_torch.ops.groupnorm import BF16_NAME as GROUPNORM_BF16_NAME
from camels_diffusion_model_tpu_torch.ops.groupnorm import (
    BF16_NARROW_NAME as GROUPNORM_NARROW_NAME,
)
from camels_diffusion_model_tpu_torch.ops.groupnorm import LARGE_NAME as GROUPNORM_LARGE_NAME
from camels_diffusion_model_tpu_torch.ops.groupnorm import PAIR_NAMES as GROUPNORM_PAIR_NAMES
from camels_diffusion_model_tpu_torch.ops.groupnorm import single_route as groupnorm_route
from camels_diffusion_model_tpu_torch.ops.sampler_step import (
    F32_BAND_NAME,
    OS_NAMES,
    fused_head_step,
    guided_eps,
    head_step_plain,
)
from camels_diffusion_model_tpu_torch.ops.sampler_step import route as head_step_route
from camels_diffusion_model_tpu_torch.ops.spectrum import power_spectrum_batch
from camels_diffusion_model_tpu_torch.ops.stats import PooledPdf, pdf_tv
from camels_diffusion_model_tpu_torch.parallel.launch import spawn
from camels_diffusion_model_tpu_torch.models.fold_bn import fold_batchnorm_variables
from camels_diffusion_model_tpu_torch.models.quantize import (
    QuantConv,
    int8_conv_sums,
    quantize_symmetric,
)
from camels_diffusion_model_tpu_torch.parallel.mesh import (
    Mesh2D,
    gather_blocks,
    init_distributed,
    make_mesh_2d,
    shard_batch,
    shard_batch_spatial,
)
from camels_diffusion_model_tpu_torch.serving import (
    certification_contexts,
    load_model,
    resolve_serving_config,
)
from camels_diffusion_model_tpu_torch.models.blocks import Conv2d, OutputConv2d
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.training import trainer
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables
from camels_diffusion_model_tpu_torch.utils import torch_interop
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

REPO = os.path.dirname(os.path.abspath(__file__))
# run_experiment writes its figures where matplotlib is installed and lists
# them as skipped where not (the card's machine has none).
NO_MATPLOTLIB = importlib.util.find_spec("matplotlib") is None
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
GOLDEN_BF16 = os.path.join(REPO, "tests", "data", "torch_port_golden_bf16.npz")
REFS = os.path.join(REPO, "artifacts", "certification", "n16k")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16, dense, on the tensor cores
FLUSH_BYTES = 4 * 50 * 2**20  # four times the H100's 50 MB L2 (see time_ms)
BATCH = 16  # maps per served batch; the decoder sees 2 * BATCH under CFG
# Kernels whose ptxas report (registers, shared memory, spills) phase (a)
# prints: the bf16 designs of K1 and K2, K1's halo kernels and K2's sharded
# launches.
PTXAS_KERNELS = ("head_step_bf16_kernel", "head_step_bf16_halo_kernel",
                 "head_step_halo_f32_kernel", "head_step_bf16_split_kernel",
                 "head_step_f32_split_kernel", "head_step_combine_kernel",
                 "groupnorm_bf16_kernel",
                 "groupnorm_bf16_narrow_kernel", "groupnorm_bf16_wide_kernel",
                 "groupnorm_stats_kernel",
                 "groupnorm_apply_kernel", "groupnorm_f32_large_kernel",
                 "head_step_f32_band_kernel", "head_step_os_kernel")

# Kernel vs plain version on the card.  K3 differs only by the fused
# multiply-adds nvcc contracts (an ulp or two of values up to ~10); K2 also
# sums its statistics in another order and uses rsqrtf; K1 sums the 1152
# terms of its conv in another order than cuDNN.
TOL = {"head_step": 1e-4, "groupnorm_act": 1e-4, "film": 1e-5,
       # The bf16 instances round where their plain versions round, from
       # fp32 sums taken in another order: an output may land on the
       # neighbouring bf16 value.  In bf16 ulps: K2's output, 2 (the FiLM
       # epilogue's two roundings may carry one on); K1's eps, 4 (the CFG
       # combine's three roundings), times the step's c_eps / sqrt(a); K3
       # computes its plain version's two roundings from the same fp32
       # operations: exact.  And all but BF16_SHARE of the elements within
       # fp32 rounding (K1: its fp32 step's FMAs, 1e-5).
       "head_step_bf16": 4, "groupnorm_act_bf16": 2, "film_bf16": 0,
       # The sharded modes (phase r1): K1's halo mode as K1; K2's apply
       # launch as K2 (its statistics merged by Chan's formula in fp32);
       # its statistics launch relative to each column's largest value
       # (count, mean, centred sum of squares), sums in another order.
       "head_step_halo": 1e-4, "groupnorm_apply": 1e-4, "groupnorm_stats": 1e-5,
       "head_step_halo_bf16": 4, "groupnorm_apply_bf16": 2, "groupnorm_stats_bf16": 1e-5,
       # The narrow bf16 kernels (K1's narrow item in both modes, K2 where
       # groups are not whole packs: narrow models), the float kernels'
       # bf16 instances, which take the bf16 shapes no bf16 kernel takes,
       # and the float kernel's halo mode, which takes the halo shapes the
       # kernels of their own do not: as those.
       "head_step_narrow_bf16": 4, "groupnorm_act_narrow_bf16": 2,
       "head_step_halo_narrow_bf16": 4,
       # K1's narrow item with a masked last block (both modes), K2's wide
       # layout: as the narrow kernels.
       "head_step_masked_bf16": 4, "head_step_halo_masked_bf16": 4,
       "groupnorm_act_wide_bf16": 2, "groupnorm_act_generic_bf16": 2,
       # The widths past the earlier kernels' limits: K1's split launch as
       # K1 (its range sums added in another order); K2's pair on one card
       # within 5e-6 of the largest value in fp32 (REL_TOL) and a bf16 ulp;
       # K3's pixels of over 1024 accesses as K3.
       "head_step_split": 1e-4, "head_step_split_bf16": 4,
       "head_step_halo_split": 1e-4, "head_step_halo_split_bf16": 4,
       "groupnorm_act_pair": 5e-6, "groupnorm_act_pair_bf16": 1, "film_wide": 1e-5,
       "film_wide_bf16": 0,
       # The fp32 designs at the deep and big variants' heads: K2's
       # large-slice kernel and K1's band kernel, as K2 and K1.
       "groupnorm_act_large": 1e-4, "head_step_band": 1e-4,
       # K1 to several image channels, both modes, and of those its
       # output-stationary kernel: as K1.
       "head_step_cout": 1e-4, "head_step_cout_bf16": 4, "head_step_halo_cout": 1e-4,
       "head_step_halo_cout_bf16": 4, "head_step_os": 1e-4, "head_step_os_bf16": 4,
       "head_step_halo_os": 1e-4, "head_step_halo_os_bf16": 4}
REL_TOL = ("groupnorm_act_pair",)  # fp32 tolerances relative to the largest value
BF16_SHARE = 1e-2
# Phase (o): the card's bf16 within BF16_FACTOR x the yardstick, the
# reference's (JAX's golden, the CPU's) bf16 distance from its fp32 on the
# same inputs, as tests/test_torch_port_bf16.py holds the port to JAX.
BF16_FACTOR = 2.0
# Full-width forward on the card vs the JAX CPU golden, and four strided
# steps on the card vs the same sampler on the CPU: cuDNN's fp32
# convolution algorithms reorder the sums of some twenty convs (observed
# about 3e-6 and 5e-7 on an H100 with TF32 off).
GOLDEN_TOL = 1e-4

# Each kernel instance: its wrapper and the wrapper's launch count for it.
WRAPPERS = {
    "head_step": (fused_head_step, "launches"),
    "groupnorm_act": (fused_groupnorm_act, "launches"),
    "film": (fused_film, "launches"),
    "head_step_bf16": (fused_head_step, "launches_bf16"),
    "groupnorm_act_bf16": (fused_groupnorm_act, "launches_bf16"),
    "film_bf16": (fused_film, "launches_bf16"),
    # The sharded modes of phase (r): K1 with halo rows, K2's two launches.
    "head_step_halo": (fused_head_step, "launches_halo"),
    "groupnorm_stats": (groupnorm_stats, "launches"),
    "groupnorm_apply": (groupnorm_apply, "launches"),
    "head_step_halo_bf16": (fused_head_step, "launches_halo_bf16"),
    "groupnorm_stats_bf16": (groupnorm_stats, "launches_bf16"),
    "groupnorm_apply_bf16": (groupnorm_apply, "launches_bf16"),
    # The narrow bf16 kernels (the narrow bf16 model of phase o: K1's
    # narrow item, K2 where groups are not whole packs), the float kernels'
    # bf16 instances (bf16 shapes no bf16 kernel takes) and the float
    # kernel's halo mode (channels the halo kernels of their own do not
    # take): their launches are also counted in head_step_bf16's,
    # groupnorm_act_bf16's, head_step_halo's and head_step_halo_bf16's.
    "head_step_narrow_bf16": (fused_head_step, "launches_narrow_bf16"),
    "groupnorm_act_narrow_bf16": (fused_groupnorm_act, "launches_narrow_bf16"),
    "head_step_halo_narrow_bf16": (fused_head_step, "launches_halo_narrow_bf16"),
    # Of those, K1's narrow item with a masked last block (c not a multiple
    # of 32) and K2's wide layout (units over 256 channels: the wide bf16
    # model of phase o).
    "head_step_masked_bf16": (fused_head_step, "launches_masked_bf16"),
    "head_step_halo_masked_bf16": (fused_head_step, "launches_halo_masked_bf16"),
    "groupnorm_act_wide_bf16": (fused_groupnorm_act, "launches_wide_bf16"),
    "groupnorm_act_generic_bf16": (fused_groupnorm_act, "launches_generic_bf16"),
    # The widths past the earlier kernels' limits (no committed model's):
    # K1's split launch in both modes, K2's statistics and apply launches
    # on one card, K3 at pixels of over 1024 accesses; counted also in
    # head_step's, head_step_halo's, groupnorm_act's and film's.
    "head_step_split": (fused_head_step, "launches_split"),
    "head_step_split_bf16": (fused_head_step, "launches_split_bf16"),
    "head_step_halo_split": (fused_head_step, "launches_halo_split"),
    "head_step_halo_split_bf16": (fused_head_step, "launches_halo_split_bf16"),
    "groupnorm_act_pair": (fused_groupnorm_act, "launches_pair"),
    "groupnorm_act_pair_bf16": (fused_groupnorm_act, "launches_pair_bf16"),
    "film_wide": (fused_film, "launches_wide"),
    "film_wide_bf16": (fused_film, "launches_wide_bf16"),
    # The fp32 designs at the deep and big variants' heads: K2's large-slice
    # kernel (slices over 48 KiB: their out_norm) and K1's band kernel
    # (widths from 128); counted also in groupnorm_act's and head_step's.
    "groupnorm_act_large": (fused_groupnorm_act, "launches_large"),
    "head_step_band": (fused_head_step, "launches_band"),
    # K1 to several image channels (a model of several CMD fields: phase
    # t), in both types and modes; counted also in head_step's,
    # head_step_bf16's, head_step_halo's and head_step_halo_bf16's.
    "head_step_cout": (fused_head_step, "launches_cout"),
    "head_step_cout_bf16": (fused_head_step, "launches_cout_bf16"),
    "head_step_halo_cout": (fused_head_step, "launches_halo_cout"),
    "head_step_halo_cout_bf16": (fused_head_step, "launches_halo_cout_bf16"),
    # Of those, the output-stationary kernel's (one CTA a band for every
    # output channel, from two channels where its plan takes the shape).
    "head_step_os": (fused_head_step, "launches_os"),
    "head_step_os_bf16": (fused_head_step, "launches_os_bf16"),
    "head_step_halo_os": (fused_head_step, "launches_halo_os"),
    "head_step_halo_os_bf16": (fused_head_step, "launches_halo_os_bf16"),
}


def instance(name: str, dtype: str) -> str:
    """The instance of kernel ``name`` ("head_step", ...) a ``dtype`` path
    launches."""
    return name if dtype == "float32" else f"{name}_bf16"

# library_ms: one PyTorch call timed beside each kernel as its yardstick;
# the port never calls it.  No single call adds K2's activation (or its FiLM
# epilogue), which move no bytes, so F.group_norm stands in for it; for K1
# the output conv, which moves 99% of its bytes.
LIBRARY = {
    "head_step": "F.conv2d(h, W, b): the output conv without the combine "
                 "or the step",
    "groupnorm_act": "F.group_norm on the channels_last NCHW view: "
                     "GroupNorm + affine without the activation or FiLM",
    "film": "torch.addcmul",
    "head_step_halo": "F.conv2d(h, W, b) of the shard with zero rows in place of the halo "
                      "rows: the output conv alone, the same bytes and operations",
    "groupnorm_stats": "torch.var_mean over each (sample, group) of the shard, "
                       "correction 0",
    "groupnorm_apply": "none: F.batch_norm(training=False) takes given statistics, but "
                       "per channel; none applies per-(sample, group) statistics with a "
                       "per-channel affine on the NHWC layout",
}
LIBRARY.update({f"{k}_bf16": f"{v}, in bf16" for k, v in LIBRARY.items()})
# The bf16 kernels' further counts (WRAPPERS): kernel and kind.
BF16_KINDS = tuple((k, "narrow") for k in ("head_step", "groupnorm_act", "head_step_halo")) + (
    ("head_step", "masked"), ("head_step_halo", "masked"), ("groupnorm_act", "wide"),
    ("groupnorm_act", "generic"))
LIBRARY.update({f"{k}_{kind}_bf16": LIBRARY[f"{k}_bf16"] for k, kind in BF16_KINDS})
# The widths past the earlier kernels' limits, in both types: kernel and kind.
WIDE_KINDS = (("head_step", "split"), ("head_step_halo", "split"), ("groupnorm_act", "pair"),
              ("film", "wide"))
LIBRARY.update({f"{k}_{kind}{sfx}": LIBRARY[f"{k}{sfx}"] for k, kind in WIDE_KINDS
                for sfx in ("", "_bf16")})
# The fp32 designs at the deep and big variants' heads: kernel and kind.
F32_KINDS = (("groupnorm_act", "large"), ("head_step", "band"))
LIBRARY.update({f"{k}_{kind}": LIBRARY[k] for k, kind in F32_KINDS})
# K1 to several image channels, both types and modes: kernel and kind (the
# library call F.conv2d to as many channels).
COUT_KINDS = (("head_step", "cout"), ("head_step_halo", "cout"), ("head_step", "os"),
              ("head_step_halo", "os"))
LIBRARY.update({f"{k}_{kind}{sfx}": LIBRARY[f"{k}{sfx}"] for k, kind in COUT_KINDS
                for sfx in ("", "_bf16")})
# Launches per reverse step: one step kernel (output conv, guidance,
# update); one decoder call with K2 at up0_norm (FiLM stage 0 as its
# epilogue) and out_norm, and K3 at stage 1.
LAUNCHES_PER_STEP = {"head_step": 1, "groupnorm_act": 2, "film": 1}
# Launches per forward of the likelihood passes: the decoder's K2 (twice)
# and K3, and out_conv2 as a conv (K1 is a sampler's step).
LAUNCHES_PER_FORWARD = {"head_step": 0, "groupnorm_act": 2, "film": 1}
# Card vs CPU on the likelihood passes, relative to the largest value: the
# NLL's weight 1/(2 b_1) = 4.4e3 puts the whole sum on t = 1's eps.
LIKELIHOOD_REL = 1e-4
ELBO_SEED = 4242  # the certification's fixed ELBO rng (certify_fast_sampler.py:284)
# Phase (l).  One train step on the card vs the CPU: the loss and the
# gradients (together, and each leaf) to 1e-4 relative, as cuDNN's weight
# gradients sum in their own order.  A leaf beyond that passes on max abs
# LEAF_ABS if its gradient is zero up to rounding (the conv biases ahead of
# a BatchNorm: norm below ROUNDING of all gradients'), which leaves no
# relative error to speak of.  Any other leaf beyond TRAIN_REL passes only
# on a witness taken in the same run: the step again on the card in float64
# and in fp32 with cuDNN off (no FFT or Winograd convolution).  It passes if
# its max abs is within LEAF_ABS, its card-vs-CPU error within
# SMALL_LEAF_REL, and the card's fp32 gradient without cuDNN within
# TRAIN_REL of the float64 one: the port's fp32 math meets the tolerance,
# and the gap is the rounding of cuDNN's algorithms (on an H100 they put
# leaves of down2 and up1 1.1e-4 to 3.5e-4 from float64, where the direct
# sums stay within 6.6e-5).  Running statistics STATS_TOL abs; a resumed
# run's state against the unbroken run's RESUME_TOL abs (cuDNN's
# deterministic algorithms for both runs).
TRAIN_BATCH, TRAIN_REAL = 32, 28  # the config's batch; 4 wrap-padded rows masked
TRAIN_REL = 1e-4
LEAF_ABS = 1e-6
ROUNDING = 1e-6  # a leaf's gradient norm below this share of all gradients'
SMALL_LEAF_REL = 1e-3
STATS_TOL = 1e-5
RESUME_TOL = 1e-5
FIXED_STEPS = 30  # Adam steps on one fixed batch
TIMED_STEPS = 20
# Substrings of the names of cuDNN's and cuBLAS's convolution kernels (FFT,
# implicit GEMM, data and weight gradients), for the conv share of a step.
CONV_KERNELS = ("fft", "xmma", "gemm", "dgrad", "wgrad", "convolve", "conv2d", "cudnn",
                "pointwise_mult_and_sum_complex")
# Phases (m) and (n): the deep and big models at full width.
VARIANT_SEED = 0  # torch.manual_seed of their init (on the CPU)
VARIANT_BATCH = 10  # maps a variant run samples (n_eval_images)
VARIANT_CHECK_BATCH = 2  # card vs CPU: forward, train step, exact-chain steps
# Card vs CPU forward at full width, abs, eps in [-1, 1]: cuDNN's fp32
# algorithms reorder the sums of some thirty convolutions.
VARIANT_TOL = 1e-4
VARIANT_STEPS = 5  # strided steps of the timed sampler path (halved to keep the script near 730 s)
VARIANT_TIMED = {"deep": (5, 3), "big": (3, 2)}  # timed and profiled train steps
# A variant's train step at batch 2 from its fresh init crosses kinks: its
# ReLUs, leaky ReLUs and max-pools each take one side or the other of a
# point where the gradient jumps, and a few of their inputs lie within fp32
# rounding of it (126 of 67 M for the deep model at full width on an
# H100).  One element whose side flips moves every gradient upstream of
# it: unpinned, any fp32 step sits 1e-3 to 1e-2 from float64, the CPU's as
# well as the card's.  So the variants' step is compared on pinned kinks
# (kink_sides): the card's float64 step records the side of each kink it
# takes, and every fp32 step takes those sides; then phase (l)'s gate
# applies as it stands.  scripts/variant_kink_check.py shows it on the CPU
# (deep, n_feat 64, 64x64: 6.9e-3 from float64 free, 6.6e-3 with the norm
# statistics in float64, 2.1e-6 pinned).
# Phase (l2): run_experiment("nov26") at the reference's T and its resume;
# no stage follows its reconstruction.  Phase (n): run_experiment cut to the
# card's time: RUN_T timesteps (the reference runs 1500; a conditional run
# samples with up to five chains of them), RUN_EPOCHS epoch(s), at most
# RUN_MAPS synthetic maps; widths and the batch of 32 as configured.
RUN_T, RUN_EPOCHS = 10, 1  # RUN_T halved with VARIANT_STEPS
# Phase (p).  The native and numpy "code" normalisations round differently
# on some pixels of maps in [0, 1]: by at most an ulp of 1.0 (2^-23).
PREP_MAPS, PREP_SIZE, PREP_TOL = 1500, 256, 2.0**-23
# The comparison CLI's maps: 8, where its default is 15.  Its exact chain of
# 1500 steps at 15 maps sits on cuDNN's fp32 cliff (a tiled FFT at most
# batch sizes but 1-5 and multiples of 8) and took 228-355 s of the
# script's 1200 s; at 8 maps cuDNN takes its fast algorithms (PERF.md
# section 5).
CLI_MAPS = 8
# Phase (q).  Two ranks sharing the card: the sampler's 5 maps split 3 + 2
# real rows and a pad row, and cuDNN picks its algorithms by batch size
# (PERF.md section 5), so a rank's maps may differ from one process's by
# the reordered sums of some twenty convolutions: MESH_TOL abs, as
# GOLDEN_TOL for the card against the CPU.
MESH_TIMEOUT = 300  # seconds the two ranks may take, start-up included
MESH_MAPS, MESH_STEPS, MESH_TOL = 5, 10, 1e-4
DPM_STEPS = 25
# Maps held against the CPU: bf16 takes 6 s a map there, so one fits the
# phase's 90 s (PERF.md Findings PR 12).
DPM_CPU_MAPS = {"float32": 4, "bfloat16": 1}
PROFILE_T, PROFILE_MAPS = 20, 90
RUN_MAPS = {"initial": 90, "main": 90, "paper": 240}
SOURCES = {
    "head_step": ("camels_diffusion_model_tpu_torch/csrc/head_step.cuh",
                  "camels_diffusion_model_tpu/ops/pallas/sampler_step.py:34"),
    "groupnorm_act": ("camels_diffusion_model_tpu_torch/csrc/groupnorm.cu",
                      "camels_diffusion_model_tpu/ops/pallas/groupnorm.py:65"),
    "film": ("camels_diffusion_model_tpu_torch/csrc/film.cu",
             "camels_diffusion_model_tpu/ops/pallas/film.py:29"),
}
SHARDED_SOURCE = ("camels_diffusion_model_tpu_torch/csrc/groupnorm_sharded.cu",
                  SOURCES["groupnorm_act"][1])
SOURCES.update({"head_step_halo": SOURCES["head_step"], "groupnorm_stats": SHARDED_SOURCE,
                "groupnorm_apply": SHARDED_SOURCE})  # modes of K1 and K2
SOURCES.update({f"{k}_bf16": v for k, v in SOURCES.items()})  # the same sources
SOURCES.update({f"{k}_{kind}_bf16": SOURCES[k] for k, kind in BF16_KINDS})
SOURCES.update({f"groupnorm_act_{kind}_bf16": (
    "camels_diffusion_model_tpu_torch/csrc/groupnorm_narrow.cu", SOURCES["groupnorm_act"][1])
    for kind in ("narrow", "wide")})
SOURCES.update({f"{k}_{kind}{sfx}": SOURCES[k] for k, kind in WIDE_KINDS
                for sfx in ("", "_bf16")})
SOURCES.update({f"{k}_{kind}": SOURCES[k] for k, kind in F32_KINDS})
SOURCES.update({f"{k}_{kind}{sfx}": SOURCES[k] for k, kind in COUT_KINDS
                for sfx in ("", "_bf16")})
# Phase (r2): the spatial chain, its one-process reference and the deep
# model's folded forward on a (1 x 2) mesh of two gloo ranks sharing the
# card.  Each rank's maps are held to one process's within SPATIAL_TOL
# (MESH_TOL's reasoning: cuDNN picks its algorithms by shape, and a shard
# is half the map).  Launches a spatial reverse step: K1's halo mode once
# (the halo kernels of their own: the float kernel's halo mode none), K2's
# statistics and apply launches at up0_norm and out_norm, K3 once; a
# spatial forward: K2's two launches at both heads and K3.
SPATIAL_MESH, SPATIAL_MAPS, SPATIAL_T, SPATIAL_TOL = (1, 2), 16, 10, 1e-4
SPATIAL_PER_STEP = {"head_step_halo": 1, "groupnorm_stats": 2, "groupnorm_apply": 2, "film": 1}
SPATIAL_PER_FORWARD = {"groupnorm_stats": 2, "groupnorm_apply": 2, "film": 1}
QUANT_BATCH = 32  # phase (r3): the training batch through down2.block2.conv2
# Phase (o): a narrow bf16 model, whose out_norm (4 channels a group) takes
# the narrow bf16 GroupNorm kernel and whose out_conv2 (32 channels) the
# bf16 step kernel's narrow item; its up0_norm (8 channels a group) keeps
# the bf16 kernel, and no launch takes a float kernel's bf16 instance.  Its
# forward and four strided w=2 steps on 2 maps, as check_sampler_vs_cpu
# takes them.  Narrow launches a decoder call: K2 at out_norm, K1 at the
# step.
NARROW_FEAT, NARROW_MAPS = 32, 2
NARROW_PER_STEP = {"head_step_narrow_bf16": 1, "groupnorm_act_narrow_bf16": 1}
NARROW_PER_FORWARD = {"groupnorm_act_narrow_bf16": 1}
# And a wide bf16 model (n_feat 264): both heads (33 and 66 channels a
# group, units of 264) take K2's wide layout, out_conv2 (264 channels)
# K1's narrow item with a masked last block; the same forward and steps.
WIDE_FEAT = 264
WIDE_PER_STEP = {"head_step_narrow_bf16": 1, "head_step_masked_bf16": 1,
                 "groupnorm_act_narrow_bf16": 2, "groupnorm_act_wide_bf16": 2}
WIDE_PER_FORWARD = {"groupnorm_act_narrow_bf16": 2, "groupnorm_act_wide_bf16": 2}
# Phase (c): the narrow kernels at n_feat 32 (2 maps: phase (o)'s, summed;
# 16 maps), 96 and 160 (16 maps); K1's masked narrow item at n_feat 264
# (2 maps: phase (o)'s, summed; 16), 40 (2, 16), 48 and 8 (16); K2's wide
# layout at n_feat 264's out_norm and up0_norm with the FiLM epilogue (2
# maps: a decoder call of phase (o)'s, summed; 16) and 280's out_norm (16).
NARROW_CASES = ((32, NARROW_MAPS, True), (32, BATCH, False), (96, BATCH, False),
                (160, BATCH, False))
MASKED_CASES = ((WIDE_FEAT, NARROW_MAPS, True), (WIDE_FEAT, BATCH, False),
                (40, NARROW_MAPS, False), (40, BATCH, False), (48, BATCH, False),
                (8, BATCH, False))
WIDE_CASES = (("out_norm", WIDE_FEAT, NARROW_MAPS, True), ("up0_norm", WIDE_FEAT, NARROW_MAPS, True),
              ("out_norm", WIDE_FEAT, BATCH, False), ("up0_norm", WIDE_FEAT, BATCH, False),
              ("out_norm", 280, BATCH, False))
# The float kernel's bf16 instance of K2 at the shapes every bf16 kernel
# refuses (no model's): 8 groups of 264 channels (over 256; 4 maps, 16x16).
GENERIC_K2 = (4, 16, 8 * 264)
# Phase (c), the widths past the earlier kernels' limits (no committed
# model's): K1's split launch under CFG at 6000 bf16 channels on 8x8 maps
# (the float template's instance there lost to F.conv2d by 17.8x) and at
# 16 maps of 64x64 past the band kernels' shared memory (fp32's at 6000 on
# 8x8 stays on the float template, which takes it; phase (r1) holds the
# split halo mode there); K2's statistics and
# apply launches on one card at the fp32 out_norm of n_feat 512 at
# 128x128, the sampler's 10 maps (a slice over SLICE_MAX, 2 MiB a group:
# over the large-slice kernel's budget; and at n_feat 384, 384 KiB slices
# the float template spilled before the pair took them), and at n_feat
# 1032's up0_norm + FiLM at 16 maps; K3 at pixels of over 1024 accesses.
SPLIT_K1 = ((1, 8, 6000, "bfloat16"), (BATCH, 64, 4840, "bfloat16"),
            (BATCH, 64, 3056, "float32"))  # maps, height and width, channels, dtype
PAIR_K2 = ((10, 128, 512, "gelu", False, "float32"), (10, 128, 384, "gelu", False, "float32"),
           (2 * BATCH, 16, 2064, "relu", True, "float32"),
           (2 * BATCH, 16, 2064, "relu", True, "bfloat16"))  # n, height, c, act, FiLM, dtype
WIDE_K3 = ((4, 32, 8192, "float32"), (4, 32, 8200, "bfloat16"))
# Phase (c), K1 to several image channels: (maps, height and width,
# channels, image channels) at the served w=2 shape and the deep model's
# w=2 step (the output-stationary kernel, or in bf16 at few channels the
# grouped kernels' one group) and at a split width (the grouped split
# launch); each kind's first case summed; phase (r1) the halo mode at half
# of the served w=2 features and of a split width.
COUT_CASES = ((BATCH, 64, 128, 2), (BATCH, 64, 128, 3), (BATCH, 64, 128, 4),
              (BATCH, 64, 128, 8), (BATCH, 64, 128, 13), (BATCH, 64, 128, 16),
              (VARIANT_BATCH, 128, 128, 13), (1, 8, 6000, 2), (1, 8, 6000, 13))
COUT_HALO = ((BATCH, 32, 64, 128, 2), (BATCH, 32, 64, 128, 3), (BATCH, 32, 64, 128, 4),
             (BATCH, 32, 64, 128, 13), (1, 4, 8, 6000, 2))  # maps, height, width, c, cout
# Phase (t): canonical models of several image channels, (in_channels,
# sampler paths) each, CHANNELS_MAPS maps a sampler on the card,
# CHANNELS_CPU_MAPS of them held against the CPU (bf16 on the CPU takes
# 0.24 s a map and step: phase q3's note); launches a step beyond
# LAUNCHES_PER_STEP's: K1 at several output channels, its output-stationary
# kernel.
CHANNELS = ((2, ("strided", "posterior")), (13, ("strided",)))
CHANNELS_MAPS = BATCH
CHANNELS_CPU_MAPS = {"float32": BATCH, "bfloat16": 4}
# Phase (s): a canonical model at n_feat 1032, 16x16 maps: its forward and
# four strided w=2 steps on 2 maps.  Launches a decoder call beyond
# LAUNCHES_PER_STEP's: the pair at up0_norm; in bf16 out_norm's wide
# layout (129 channels a group) and out_conv2's masked narrow item.
PAIR_FEAT, PAIR_SIZE = 1032, 16
PAIR_PER_FORWARD = {"float32": {"groupnorm_act_pair": 1},
                    "bfloat16": {"groupnorm_act_pair_bf16": 1, "groupnorm_act_narrow_bf16": 1,
                                 "groupnorm_act_wide_bf16": 1}}
PAIR_PER_STEP = {"float32": {"groupnorm_act_pair": 1},
                 "bfloat16": {"groupnorm_act_pair_bf16": 1, "groupnorm_act_narrow_bf16": 1,
                              "groupnorm_act_wide_bf16": 1, "head_step_narrow_bf16": 1,
                              "head_step_masked_bf16": 1}}


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def nbytes(*args) -> int:
    """Bytes of the tensors among ``args`` (tuples are searched too)."""
    total = 0
    for a in args:
        if isinstance(a, tuple):
            total += nbytes(*a)
        elif torch.is_tensor(a):
            total += a.numel() * a.element_size()
    return total


def copy_args(args):
    """``args`` with every tensor (also inside tuples) cloned."""
    return tuple(copy_args(a) if isinstance(a, tuple) else
                 a.clone() if torch.is_tensor(a) else a for a in args)


def time_ms(fn, args, iters: int = 20, replays: int = 5, warm: bool = False) -> float:
    """Device ms per call of ``fn(*args)`` with its data in device memory.

    The calls are captured in one CUDA graph, replayed ``replays`` times
    between CUDA events, which takes the host's per-call launch cost out of
    the measurement.  Each captured call takes its own copy of the tensor
    arguments and keeps its output, and the copies come round again only
    after four times the L2's bytes, so a call finds neither its inputs nor
    its output's lines in L2 and the byte bound at ``HBM_BYTES_PER_S`` is a
    floor.  ``warm``: every call takes one copy, which the last call left
    in L2 (as a served step finds the features the layer before wrote)."""
    out = fn(*args)  # warm-up outside the capture
    copies = 1 if warm else -(-FLUSH_BYTES // max(1, nbytes(*args, out)))
    iters = copies * -(-iters // copies)
    sets = [copy_args(args) for _ in range(copies)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(iters):
            outs.append(fn(*sets[i % copies]))
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def check_kernels(dev, model) -> dict:
    """Phase (c): each kernel vs its plain version at the shapes each main
    path gives it: serving w=2 (decoder batch 32; posterior DDIM's too),
    serving w=0 (16; the battery's ELBO forwards too) and the exact chain
    (4; the NLL sweep's and reconstruction's too).

    Also the deep and big models' shapes (:func:`check_variant`'s batch of
    10 maps and the validation batch of 32).

    Returns per kernel the worst error over all its cases, each case's
    numbers (``shapes``), and the summed times and bounds of its summed
    cases: the launch of one reverse step
    (K1: output conv, guidance, update) or one decoder call (K2: up0_norm
    with the FiLM epilogue and out_norm) of the w=2 serving batch, and for
    K3 both FiLM stages (stage 0 is timed for continuity; the path runs it
    as K2's epilogue).  The other cases are printed for information; their
    errors are held to the same tolerance.
    """
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    n = 2 * BATCH
    cases = []  # (kernel, label, kernel fn, plain fn, library fn, args, bytes, flops, summed)
    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(
        make_schedule(TIMESTEPS), torch.tensor([750])
    )[0].tolist()
    # K1 on out_norm's features (ReLU'd, as the decoder gives them) with
    # the serving model's out_conv2.
    head = (model.out_conv2.weight.detach(), model.out_conv2.bias.detach())
    for label, b, cfg, w, with_z in (("cfg w=2 (serve w=2)", BATCH, True, 2.0, True),
                                     ("cfg per-sample w", BATCH, True, "vector", True),
                                     ("cfg w=2, sigma=0", BATCH, True, 2.0, False),
                                     ("no cfg (serve w=0)", BATCH, False, None, True),
                                     ("no cfg (exact chain)", 4, False, None, True)):
        x, z = randn(b, 64, 64, 1), randn(b, 64, 64, 1)
        h = randn(2 * b if cfg else b, 64, 64, model.n_feat).relu()
        if w == "vector":
            w = torch.linspace(1.0, 3.0, b, device=dev)
        args = (h, *head, x, z if with_z else None, c_eps, inv_sqrt_a,
                sigma if with_z else 0.0, w)
        cases.append((
            "head_step", f"{label} h{tuple(h.shape)} x{tuple(x.shape)}",
            fused_head_step, head_step_plain,
            lambda h, weight, bias, *_: F.conv2d(h.permute(0, 3, 1, 2), weight, bias,
                                                 padding=1),
            args, nbytes(*args, x), h.numel() * 18 + x.numel() * (8 if cfg else 5),
            isinstance(w, float) and with_z,  # the w=2 serving path's form
        ))
    # K1 at the deep and big heads (width 128, 128 and 256 channels) with
    # the tanh of their output layer, at the sampling batch of 10 maps, with
    # and without CFG; weights drawn at the scale of out_conv2's init.
    # The band kernel where the route gives it the shape, each kernel's
    # first case summed.
    seen = set()
    for label, c, cfg in (("deep, tanh (initial)", 128, False), ("big, tanh (main)", 256, False),
                          ("deep, tanh, cfg w=2", 128, True), ("big, tanh, cfg w=2", 256, True)):
        b = VARIANT_BATCH
        x, z = randn(b, 128, 128, 1), randn(b, 128, 128, 1)
        h = randn(2 * b if cfg else b, 128, 128, c)
        weight = randn(1, c, 3, 3).mul(1 / (3 * c**0.5))
        args = (h, weight, randn(1), x, z, c_eps, inv_sqrt_a, sigma, 2.0 if cfg else None, True)
        name = ("head_step_band" if head_step_route(b, 128, 128, c, torch.float32, cfg=cfg)[0]
                == F32_BAND_NAME else "head_step")
        summed = name == "head_step_band" and name not in seen
        seen.add(name)
        cases.append((
            name, f"{label} h{tuple(h.shape)} x{tuple(x.shape)}",
            fused_head_step, head_step_plain,
            lambda h, weight, bias, *_: torch.tanh(F.conv2d(h.permute(0, 3, 1, 2), weight,
                                                            bias, padding=1)),
            args, nbytes(*args, x), h.numel() * 18 + x.numel() * (8 if cfg else 5), summed,
        ))
    # K2 as the decoder holds it; the FiLM rows as the sampler gives them:
    # the context embedding one row per sample, the time embedding one row.
    blocks = (("up0_norm + FiLM epilogue (serve w=2)", model.up0_norm, n, 16, True, True),
              ("up0_norm + FiLM epilogue (serve w=0)", model.up0_norm, BATCH, 16, True, False),
              ("up0_norm + FiLM epilogue (exact chain)", model.up0_norm, 4, 16, True, False),
              ("up0_norm", model.up0_norm, n, 16, False, False),
              ("out_norm (serve w=2)", model.out_norm, n, 64, False, True),
              ("out_norm (serve w=0)", model.out_norm, BATCH, 64, False, False),
              ("out_norm (exact chain)", model.out_norm, 4, 64, False, False))
    # The deep and big models' heads: sampling (10 maps) and validation (32).
    for batch in (VARIANT_BATCH, TRAIN_BATCH):
        for label, c, hw, act, film in (("deep up0_norm + FiLM", 512, 16, "leaky_relu", True),
                                        ("big up0_norm + FiLM", 1024, 16, "gelu", True),
                                        ("deep out_norm", 128, 128, "leaky_relu", False),
                                        ("big out_norm", 256, 128, "gelu", False)):
            blocks += ((label, types.SimpleNamespace(weight=randn(c), bias=randn(c), act=act),
                        batch, hw, film, False),)
    for label, mod, batch, hw, film, summed in blocks:
        c = mod.weight.shape[0]
        xg = randn(batch, hw, hw, c)
        rows_film = (randn(batch, c), randn(1, c)) if film else None
        args = (xg, mod.weight.detach(), mod.bias.detach(), 8, 1e-5, mod.act, rows_film)
        name = "groupnorm_act"
        if groupnorm_route(batch, hw * hw, c, 8, torch.float32)[0] == GROUPNORM_LARGE_NAME:
            name, summed = "groupnorm_act_large", "groupnorm_act_large" not in seen
            seen.add(name)  # its first case summed
        cases.append((
            name, f"{label} {tuple(xg.shape)}",
            fused_groupnorm_act, groupnorm_act_plain,
            lambda x, gamma, beta, *_: F.group_norm(x.permute(0, 3, 1, 2), 8, gamma, beta, 1e-5),
            args, nbytes(*args, xg), xg.numel() * (12 if film else 10), summed,
        ))
    for label, batch, shape, summed in (("stage 0", n, (16, 16, 256), True),
                                        ("stage 1 (serve w=2)", n, (32, 32, 128), True),
                                        ("stage 1 (serve w=0)", BATCH, (32, 32, 128), False),
                                        ("stage 1 (exact chain)", 4, (32, 32, 128), False),
                                        ("deep stage 1", VARIANT_BATCH, (32, 32, 256), False),
                                        ("big stage 1", VARIANT_BATCH, (32, 32, 512), False),
                                        ("deep stage 1", TRAIN_BATCH, (32, 32, 256), False),
                                        ("big stage 1", TRAIN_BATCH, (32, 32, 512), False)):
        args = (randn(batch, *shape), randn(batch, shape[-1]), randn(1, shape[-1]))
        cases.append((
            "film", f"{label} {tuple(args[0].shape)}", fused_film, film_plain,
            lambda x, scale, shift: torch.addcmul(
                shift[:, None, None, :], x, scale[:, None, None, :]),
            args, nbytes(*args, args[0]), args[0].numel() * 2, summed,
        ))

    cases += bf16_cases(model, randn, c_eps, inv_sqrt_a, sigma)
    cases += wide_cases(randn, c_eps, inv_sqrt_a, sigma)
    cases += cout_cases(randn)
    return hold_cases(cases)


def head_args(randn, dtype, b, height, width, c, cout, cfg=True, halo=False):
    """K1's arguments for ``b`` maps of ``height`` x ``width`` features of
    ``c`` channels to ``cout`` image channels (weights at out_conv2's init
    scale; under CFG w=2), as the step at t = 750 gives them; with
    ``halo`` the rows above and below."""
    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(
        make_schedule(TIMESTEPS), torch.tensor([750]))[0].tolist()
    h = randn(2 * b if cfg else b, height, width, c).relu().to(dtype)
    rows = (tuple(randn(h.shape[0], width, c).relu().to(dtype) for _ in range(2)),) if halo \
        else ()
    return (h, randn(cout, c, 3, 3).mul(1 / (3 * c**0.5)).to(dtype), randn(cout).to(dtype),
            randn(b, height, width, cout), randn(b, height, width, cout), c_eps, inv_sqrt_a,
            sigma, 2.0 if cfg else None, False, *rows)


def cout_kind(b, height, width, c, dtype, cout, halo=False) -> str:
    """The kind K1's launch at ``cout`` channels counts under: ``os`` where
    the route gives the output-stationary kernel, else ``cout``."""
    name = head_step_route(b, height, width, c, dtype, cout, halo=halo)[0]
    return "os" if name == OS_NAMES[dtype] else "cout"


def cout_cases(randn) -> list:
    """Phase (c)'s cases of K1 to several image channels (``COUT_CASES``),
    in both types, by the kernel the route gives: at the served w=2 shape
    and the deep model's step the output-stationary kernel (in bf16 at few
    channels the grouped kernels' one group), at a split width the grouped
    split launch; each kind's first case summed."""
    cases, seen = [], set()
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        for b, hw, c, cout in COUT_CASES:
            args = head_args(randn, dtype, b, hw, hw, c, cout)
            h = args[0]
            name = f"head_step_{cout_kind(b, hw, hw, c, dtype, cout)}{sfx}"
            summed = name not in seen
            seen.add(name)
            cases.append((
                name,
                f"{cout} image channels, cfg w=2 h{tuple(h.shape)} "
                f"{_build.type_name(dtype)}, x{tuple(args[3].shape)} fp32", fused_head_step,
                head_step_plain,
                lambda h, weight, bias, *_: F.conv2d(h.permute(0, 3, 1, 2), weight, bias,
                                                     padding=1),
                args, nbytes(*args, args[3]), h.numel() * 18 * cout + args[3].numel() * 8,
                summed))
    return cases


def wide_cases(randn, c_eps, inv_sqrt_a, sigma) -> list:
    """Phase (c)'s cases at the widths past the earlier kernels' limits (no
    committed model's), each kernel's first case summed: K1's split launch
    (``SPLIT_K1``, under CFG at w=2, weights at out_conv2's init scale),
    K2's statistics and apply launches on one card (``PAIR_K2``, the FiLM
    rows as the sampler gives them) and K3 at pixels of over 1024 accesses
    (``WIDE_K3``)."""
    cases, seen = [], set()

    def first(name):
        summed = name not in seen
        seen.add(name)
        return summed

    for b, hw, c, dtype in SPLIT_K1:
        dt, sfx = getattr(torch, dtype), "" if dtype == "float32" else "_bf16"
        x, z = randn(b, hw, hw, 1), randn(b, hw, hw, 1)
        h = randn(2 * b, hw, hw, c).relu().to(dt)
        args = (h, randn(1, c, 3, 3).mul(1 / (3 * c**0.5)).to(dt), randn(1).to(dt), x, z,
                c_eps, inv_sqrt_a, sigma, 2.0, False)
        name = f"head_step_split{sfx}"
        cases.append((
            name, f"{c} channels, cfg w=2, {b} maps h{tuple(h.shape)} {dtype}, "
            f"x{tuple(x.shape)} fp32", fused_head_step, head_step_plain,
            lambda h, weight, bias, *_: F.conv2d(h.permute(0, 3, 1, 2), weight, bias, padding=1),
            args, nbytes(*args, x), h.numel() * 18 + x.numel() * 8, first(name)))
    for n, hw, c, act, film, dtype in PAIR_K2:
        dt, sfx = getattr(torch, dtype), "" if dtype == "float32" else "_bf16"
        xg = randn(n, hw, hw, c).to(dt)
        rows_film = (randn(n, c).to(dt), randn(1, c).to(dt)) if film else None
        args = (xg, randn(c), randn(c), 8, 1e-5, act, rows_film)
        name = f"groupnorm_act_pair{sfx}"
        cases.append((
            name, f"{c // 8} channels a group, {act}" + (" + FiLM epilogue" if film else "")
            + f" {tuple(xg.shape)} {dtype}", fused_groupnorm_act, groupnorm_act_plain,
            lambda x, gamma, beta, *_: F.group_norm(x.permute(0, 3, 1, 2), 8, gamma.to(x.dtype),
                                                    beta.to(x.dtype), 1e-5),
            args, nbytes(*args, xg), xg.numel() * (12 if film else 10), first(name)))
    for n, hw, c, dtype in WIDE_K3:
        dt, sfx = getattr(torch, dtype), "" if dtype == "float32" else "_bf16"
        args = (randn(n, hw, hw, c).to(dt), randn(n, c).to(dt), randn(1, c).to(dt))
        name = f"film_wide{sfx}"
        cases.append((
            name, f"{c} channels {tuple(args[0].shape)} {dtype}", fused_film, film_plain,
            lambda x, scale, shift: torch.addcmul(
                shift[:, None, None, :], x, scale[:, None, None, :]),
            args, nbytes(*args, args[0]), args[0].numel() * 2, first(name)))
    return cases


def stats_error(got, want) -> float:
    """K2's statistics launch against its plain version: the largest error
    of each of count, mean and centred sum of squares relative to that
    column's largest value, the worst of the three."""
    diff = (got - want).abs().flatten(0, -2).amax(0)
    return (diff / want.abs().flatten(0, -2).amax(0).clamp_min(1e-30)).max().item()


def hold_cases(cases) -> dict:
    """Each case ``(kernel, label, kernel fn, plain fn, library fn, args,
    bytes, flops, summed)``: the kernel against its plain version within
    its tolerance, and the kernel's, plain version's and library call's
    device ms beside the bound (see :func:`check_kernels`)."""
    out = {}
    for name, label, kern, plain, lib, args, nb, flops, summed in cases:
        got, want = kern(*args), plain(*args)
        diff = (got.float() - want.float()).abs()
        err = (stats_error(got, want) if name.startswith("groupnorm_stats")
               else diff.max().item())
        tol, fp32_rounding = tolerance(name, args, want)
        share = (diff > fp32_rounding).float().mean().item()
        torch.cuda.synchronize()
        if not err <= tol:
            raise SystemExit(f"{name} {label}: max abs err {err} > {tol}")
        if name.endswith("_bf16") and not share <= BF16_SHARE:
            raise SystemExit(f"{name} {label}: {share:.4f} of the elements differ by more "
                             f"than {fp32_rounding}, over {BF16_SHARE}")
        ms, plain_ms = time_ms(kern, args), time_ms(plain, args)
        warm_ms = time_ms(kern, args, warm=True)
        lib_ms = time_ms(lib, args) if lib is not None else None
        peak = BF16_FLOPS if name.endswith("_bf16") else FP32_FLOPS
        bound_by = "bytes" if nb / HBM_BYTES_PER_S >= flops / peak else "operations"
        bound_ms = max(nb / HBM_BYTES_PER_S, flops / peak) * 1e3
        moved = nb + (reread_bytes(args[0], args[3]) if name.startswith("groupnorm_act")
                      else 0)
        print(f"  {name} {label}: max_abs_err {err:.3e} (tol {tol:g}"
              + (f"; {share:.4f} differ beyond {fp32_rounding:g}" if name.endswith("_bf16")
                 else "") + ") "
              f"ms {ms:.5f} warm_ms {warm_ms:.5f} plain_ms {plain_ms:.5f} library_ms {lib_ms} "
              f"({LIBRARY[name]}) bound_ms {bound_ms:.6f} ({bound_by}, {nb} bytes) "
              f"share of bound {bound_ms / ms:.3f}"
              + (f"; bytes it moves {moved} (pixels read again: earlier rounds or the "
                 f"apply launch), bound {moved / HBM_BYTES_PER_S * 1e3:.6f} ms"
                 if moved != nb else "")
              + ("" if summed else " (information)"), flush=True)
        r = out.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "warm_ms": 0.0,
                                  "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": bound_by,
                                  "library_ms": None, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append({"case": label, "max_abs_err": err, "ms": ms, "warm_ms": warm_ms,
                            "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                            "moved_bound_ms": moved / HBM_BYTES_PER_S * 1e3})
        if not summed:
            continue
        r["ms"] += ms
        r["warm_ms"] += warm_ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
    return out


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 values at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(v, 2.0**-126))) - 7)


def tolerance(name: str, args, want) -> tuple:
    """``(max abs tolerance, fp32 rounding)`` of a kernel case against its
    plain version's output ``want`` (``TOL``)."""
    if not name.endswith("_bf16"):
        if name in REL_TOL:
            return TOL[name] * want.float().abs().max().item(), 0.0
        return TOL[name], 0.0
    if name.startswith("groupnorm_stats"):
        return TOL[name], float("inf")  # relative, per column (stats_error)
    if name.startswith("head_step") and name.endswith("_bf16"):
        h, weight, bias, _, _, c_eps, inv_sqrt_a, _, w, tanh = args[:10]
        eps = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.float(), bias.float(), padding=1)
        eps = guided_eps(eps.bfloat16(), w, tanh).float()
        return (TOL[name] * abs(c_eps * inv_sqrt_a) * bf16_ulp(eps.abs().max().item()),
                1e-5)
    return TOL[name] * bf16_ulp(want.float().abs().max().item()), 0.0


def bf16_cases(model, randn, c_eps, inv_sqrt_a, sigma) -> list:
    """Phase (c)'s cases of the bf16 instances: the canonical w=2 serving
    shapes (summed: one reverse step of the bf16 model) and w=0, and the
    deep and big models' shapes at 10 maps; weights and norm parameters of
    the serving model, features and rows in bf16.  And the narrow kernels
    at the narrow bf16 models' K1 and out_norm shapes, and the float
    kernel's bf16 instance of K2 at groups no bf16 kernel takes."""
    bf = torch.bfloat16
    cases = []
    head = (model.out_conv2.weight.detach().to(bf), model.out_conv2.bias.detach().to(bf))
    for label, b, hw, c, cfg, tanh, summed in (
            ("cfg w=2 (serve w=2)", BATCH, 64, model.n_feat, True, False, True),
            ("no cfg (serve w=0)", BATCH, 64, model.n_feat, False, False, False),
            ("deep, tanh (initial)", VARIANT_BATCH, 128, 128, False, True, False),
            ("big, tanh (main)", VARIANT_BATCH, 128, 256, False, True, False)):
        x, z = randn(b, hw, hw, 1), randn(b, hw, hw, 1)
        h = randn(2 * b if cfg else b, hw, hw, c).relu().to(bf)
        weight, bias = head if c == model.n_feat else (
            randn(1, c, 3, 3).mul(1 / (3 * c**0.5)).to(bf), randn(1).to(bf))
        args = (h, weight, bias, x, z, c_eps, inv_sqrt_a, sigma, 2.0 if cfg else None, tanh)
        cases.append((
            "head_step_bf16", f"{label} h{tuple(h.shape)} bf16, x{tuple(x.shape)} fp32",
            fused_head_step, head_step_plain,
            lambda h, weight, bias, *_: F.conv2d(h.permute(0, 3, 1, 2), weight, bias,
                                                 padding=1),
            args, nbytes(*args, x), h.numel() * 18 + x.numel() * (8 if cfg else 5), summed))
    n = 2 * BATCH
    for label, batch, hw, c, act, film, norm, summed in (
            ("up0_norm + FiLM epilogue (serve w=2)", n, 16, 256, "relu", True,
             model.up0_norm, True),
            ("out_norm (serve w=2)", n, 64, 128, "relu", False, model.out_norm, True),
            ("deep up0_norm + FiLM", VARIANT_BATCH, 16, 512, "leaky_relu", True, None, False),
            ("big up0_norm + FiLM", VARIANT_BATCH, 16, 1024, "gelu", True, None, False),
            ("deep out_norm", VARIANT_BATCH, 128, 128, "leaky_relu", False, None, False),
            ("big out_norm (resident in bf16)", VARIANT_BATCH, 128, 256, "gelu", False,
             None, False)):
        gamma, beta = ((norm.weight.detach(), norm.bias.detach()) if norm is not None
                       else (randn(c), randn(c)))
        xg = randn(batch, hw, hw, c).to(bf)
        rows_film = (randn(batch, c).to(bf), randn(1, c).to(bf)) if film else None
        args = (xg, gamma, beta, 8, 1e-5, act, rows_film)
        cases.append((
            "groupnorm_act_bf16", f"{label} {tuple(xg.shape)}",
            fused_groupnorm_act, groupnorm_act_plain,
            lambda x, gamma, beta, *_: F.group_norm(x.permute(0, 3, 1, 2), 8, gamma.to(x.dtype),
                                                    beta.to(x.dtype), 1e-5),
            args, nbytes(*args, xg), xg.numel() * (12 if film else 10), summed))
    # The narrow kernels at the narrow bf16 models' shapes (NARROW_CASES:
    # phase (o)'s strided w=2 steps summed, the rest served at BATCH maps),
    # K1's masked narrow item (MASKED_CASES) and K2's wide layout
    # (WIDE_CASES) likewise, and the float kernel's bf16 instance of K2 at
    # the shapes no bf16 kernel takes (GENERIC_K2).
    head_cases = [(f"n_feat {c}, cfg w=2" + (" (phase o)" if summed else f", {b} maps"),
                   "head_step_narrow_bf16", b, 64, c, summed) for c, b, summed in NARROW_CASES]
    head_cases += [(f"n_feat {c}, cfg w=2" + (" (phase o)" if summed else "") + f", {b} maps",
                    "head_step_masked_bf16", b, 64, c, summed) for c, b, summed in MASKED_CASES]
    for label, name, b, hw, c, summed in head_cases:
        x, z = randn(b, hw, hw, 1), randn(b, hw, hw, 1)
        h = randn(2 * b, hw, hw, c).relu().to(bf)
        args = (h, randn(1, c, 3, 3).mul(1 / (3 * c**0.5)).to(bf), randn(1).to(bf), x, z,
                c_eps, inv_sqrt_a, sigma, 2.0, False)
        cases.append((
            name, f"{label} h{tuple(h.shape)} bf16, x{tuple(x.shape)} fp32",
            fused_head_step, head_step_plain,
            lambda h, weight, bias, *_: F.conv2d(h.permute(0, 3, 1, 2), weight, bias,
                                                 padding=1),
            args, nbytes(*args, x), h.numel() * 18 + x.numel() * 8, summed))
    norm_cases = [(f"out_norm, n_feat {c}" + (" (phase o)" if summed else "") + f", {b} maps",
                   "groupnorm_act_narrow_bf16", 2 * b, 64, c, False, summed)
                  for c, b, summed in NARROW_CASES]
    norm_cases += [(f"{head}" + (" + FiLM epilogue" if head == "up0_norm" else "")
                    + f", n_feat {nf}" + (" (phase o)" if summed else "") + f", {b} maps",
                    "groupnorm_act_wide_bf16", 2 * b, 16 if head == "up0_norm" else 64,
                    2 * nf if head == "up0_norm" else nf, head == "up0_norm", summed)
                   for head, nf, b, summed in WIDE_CASES]
    norm_cases.append((f"groups of {GENERIC_K2[2] // 8} channels (no model's: over 256)",
                       "groupnorm_act_generic_bf16", GENERIC_K2[0], GENERIC_K2[1], GENERIC_K2[2],
                       False, True))
    for label, name, batch, hw, c, film, summed in norm_cases:
        xg = randn(batch, hw, hw, c).to(bf)
        rows_film = (randn(batch, c).to(bf), randn(1, c).to(bf)) if film else None
        args = (xg, randn(c), randn(c), 8, 1e-5, "relu", rows_film)
        cases.append((
            name, f"{label} {tuple(xg.shape)}",
            fused_groupnorm_act, groupnorm_act_plain,
            lambda x, gamma, beta, *_: F.group_norm(x.permute(0, 3, 1, 2), 8, gamma.to(x.dtype),
                                                    beta.to(x.dtype), 1e-5),
            args, nbytes(*args, xg), xg.numel() * (12 if film else 10), summed))
    for label, batch, shape, summed in (("stage 0", n, (16, 16, 256), True),
                                        ("stage 1 (serve w=2)", n, (32, 32, 128), True),
                                        ("deep stage 1", VARIANT_BATCH, (32, 32, 256), False),
                                        ("big stage 1", VARIANT_BATCH, (32, 32, 512), False)):
        args = (randn(batch, *shape).to(bf), randn(batch, shape[-1]).to(bf),
                randn(1, shape[-1]).to(bf))
        cases.append((
            "film_bf16", f"{label} {tuple(args[0].shape)}", fused_film, film_plain,
            lambda x, scale, shift: torch.addcmul(
                shift[:, None, None, :], x, scale[:, None, None, :]),
            args, nbytes(*args, args[0]), args[0].numel() * 2, summed))
    return cases


def check_golden(dev, model, bf16: bool = False) -> None:
    """Phase (d): the folded serving model at full width vs the JAX eps.
    Phase (o), ``bf16``: the model folded in bf16 vs JAX's folded bf16
    (``GOLDEN_BF16``), within ``BF16_FACTOR`` x that file's yardstick, its
    bf16 eps's distance from its fp32 eps."""
    d = np.load(GOLDEN)
    want, tols = {k: d[k] for k in ("eps", "eps_uncond")}, {}
    if bf16:
        g = np.load(GOLDEN_BF16)
        for k in ("eps", "eps_uncond"):
            want[k] = g[f"{k}_bf16"]
            tols[k] = BF16_FACTOR * float(np.abs(g[f"{k}_bf16"] - g[f"{k}_fp32"]).max())
        tols["cfg pair"] = max(tols.values())
    x, t, c = (torch.tensor(d[k], device=dev) for k in ("x", "t", "c"))
    with torch.inference_mode():
        eps = model(x, t, c)
        eps_u = model(x, t, torch.zeros_like(c))
        # The sampler's guided form: encoder once, decoder on [cond, uncond].
        enc = model.encode(x).doubled()
        cemb1, cemb2 = model.context_embed(torch.cat([c, torch.zeros_like(c)]))
        temb1, temb2 = model.time_embed(torch.cat([t, t]))
        eps2 = model.decode(enc, film=(cemb1, temb1, cemb2, temb2))
    if (eps.dtype == torch.bfloat16) != bf16:
        raise SystemExit(f"golden forward: eps is {eps.dtype}")
    errs = {
        "eps": (eps.float().cpu().numpy() - want["eps"]),
        "eps_uncond": (eps_u.float().cpu().numpy() - want["eps_uncond"]),
        "cfg pair": (eps2.float().cpu().numpy()
                     - np.concatenate([want["eps"], want["eps_uncond"]])),
    }
    for label, e in errs.items():
        err, tol = float(np.abs(e).max()), tols.get(label, GOLDEN_TOL)
        print(f"  golden{' bf16' if bf16 else ''} {label}: max abs err {err:.3e} (tol {tol:g}"
              + (f" = {BF16_FACTOR:g} x JAX's bf16 vs fp32" if bf16 else "") + ")")
        if not err <= tol:
            raise SystemExit(f"golden forward {label}: {err} > {tol}")


def check_sampler_vs_cpu(models, taus, sigma_mode: str, label: str, size: int = 64,
                         guide_w: float = 2.0, maps: int = 2, cpu_maps: int = 0) -> None:
    """The steps ``taus`` (the last ones of a row) of the sampler at
    ``guide_w`` at full width on the card (the kernels) vs the CPU (their
    plain versions) on ``maps`` maps of the models' image channels, same
    x_init, params and z (``cpu_maps``: the CPU takes the first of them, as
    phase (q3) holds the first maps; 0: all); ``models`` = (card, CPU),
    or (card, CPU, CPU fp32) for bf16 models: then the gate is
    ``BF16_FACTOR`` x the CPU's bf16 distance from its fp32.  Wide jumps
    would amplify the fp32 differences of the convs by 1/sqrt(a_jump) per
    step."""
    rs = np.random.RandomState(0)
    shape = (maps, size, size, models[1].in_channels)
    x0 = rs.randn(*shape).astype(np.float32)
    params = rs.rand(maps, models[1].n_cfeat).astype(np.float32)
    zs = [torch.tensor(rs.randn(*shape).astype(np.float32)) for _ in taus]
    outs = []
    for i, model in enumerate(models):
        k = maps if i == 0 or not cpu_maps else cpu_maps
        outs.append(sample_ddim(
            model, make_schedule(TIMESTEPS), torch.Generator(device=on(model)),
            params=params[:k], guide_w=guide_w, x_init=x0[:k], taus=np.asarray(taus),
            sigma_mode=sigma_mode, device=on(model), z_fn=lambda j, t, k=k: zs[j][:k],
        ).cpu())
    if tuple(outs[0].shape) != shape or not bool(torch.isfinite(outs[0]).all()):
        raise SystemExit(f"{label}: maps of shape {tuple(outs[0].shape)}, expected {shape}, "
                         "or not all finite")
    outs[0] = outs[0][:outs[1].shape[0]]
    err = (outs[0] - outs[1]).abs().max().item()
    tol, what = GOLDEN_TOL, ""
    if len(models) == 3:
        yard = (outs[1] - outs[2]).abs().max().item()
        tol, what = BF16_FACTOR * yard, f" = {BF16_FACTOR:g} x the CPU's bf16 vs fp32 {yard:.3e}"
    print(f"  {label}, last {len(taus)} steps {[int(t) for t in taus]}, card vs CPU"
          + (f" (the first {cpu_maps} of {maps} maps)" if cpu_maps else "")
          + f": max abs err {err:.3e} (tol {tol:g}{what})", flush=True)
    if not err <= tol:
        raise SystemExit(f"{label} on the card vs the CPU: {err} > {tol}")


def check_likelihood_vs_cpu(models, fn, x, c, n_noise: int, label: str,
                            fail: bool = True) -> bool:
    """``fn(model, x, c, noise_fn)`` -> ``(B,)`` on the card and the CPU
    (``models``) with the same ``n_noise`` noise tensors: whether they agree
    within ``LIKELIHOOD_REL`` of the largest value (if not, and ``fail``,
    the run fails).  With a third model (the CPU's fp32, for bf16 models)
    the tolerance is ``BF16_FACTOR`` x the CPU's bf16 distance from it."""
    rs = np.random.RandomState(1)
    noise = [rs.randn(*x.shape).astype(np.float32) for _ in range(n_noise)]
    outs = [fn(m, x, c, lambda bi, k, t, shape: noise[k]).double().cpu() for m in models]
    rel = ((outs[0] - outs[1]).abs().max() / outs[1].abs().max()).item()
    tol, what = LIKELIHOOD_REL, ""
    if len(models) == 3:
        yard = ((outs[1] - outs[2]).abs().max() / outs[1].abs().max()).item()
        tol = BF16_FACTOR * yard
        what = f" = {BF16_FACTOR:g} x the CPU's bf16 vs fp32 {yard:.3e}; fp32 {outs[2].tolist()}"
    print(f"  {label}: card {outs[0].tolist()} CPU {outs[1].tolist()}: rel err "
          f"{rel:.3e} (tol {tol:g}{what})")
    if fail and not rel <= tol:
        raise SystemExit(f"{label} on the card vs the CPU: rel {rel} > {tol}")
    return rel <= tol


def on(model) -> torch.device:
    return next(model.parameters()).device


def check_maps(maps, n: int, label: str, size: int = 64) -> None:
    if tuple(maps.shape) != (n, size, size, 1) or not bool(torch.isfinite(maps).all()):
        raise SystemExit(f"{label}: maps of shape {tuple(maps.shape)}, "
                         "or not all finite")


def pk_deviation(pk: np.ndarray, w: int) -> str:
    """Max and median |P(k)/P_ref - 1| of the mean of per-map spectra ``pk``
    over the populated non-DC bins, against the N=16384 exact-chain
    reference of seed A, whose maps were drawn on the same test-split
    contexts.  For information only: a map's power moves with its context
    at every k at once, so a few maps' mean is off coherently across the
    bins (the statistical hold is ROADMAP section 1, item 3)."""
    ref = np.load(os.path.join(REFS, f"w{w}", "DDPM_1500_seed_A.npz"))["pk"]
    keep = np.arange(ref.size) > 0
    keep &= ref > 0
    dev = np.abs(pk.mean(0)[keep] / ref[keep] - 1.0) * 100
    return f"max {dev.max():.2f}% median {np.median(dev):.2f}%"


def train_batch(seed: int = 0):
    """A full-width training batch: ``TRAIN_REAL`` synthetic maps in the
    ``code`` normalisation, wrap-padded to ``TRAIN_BATCH`` rows with the
    pad rows masked, contexts, and the injected t and noise."""
    rs = np.random.RandomState(seed)
    maps, _ = synthetic_camels(n_param_sets=2, maps_per_set=15, size=64, seed=seed)
    idx = np.arange(TRAIN_BATCH) % TRAIN_REAL
    x = normalize_maps(maps[:TRAIN_REAL]).astype(np.float32)[idx, ..., None]
    c = rs.rand(TRAIN_REAL, 6).astype(np.float32)[idx]
    mask = (np.arange(TRAIN_BATCH) < TRAIN_REAL).astype(np.float32)
    t = rs.randint(1, TIMESTEPS + 1, TRAIN_BATCH)
    noise = rs.randn(TRAIN_BATCH, 64, 64, 1).astype(np.float32)
    return x, c, mask, torch.tensor(t), torch.tensor(noise)


def training_model(variables, device, dtype=torch.float32) -> ContextUnet:
    """The unfolded full-width model holding ``variables``, for training,
    computing in ``dtype`` (its parameters fp32)."""
    model = ContextUnet(dtype=dtype)
    model.load_state_dict(from_jax_variables(variables))
    return model.to(device=device, memory_format=torch.channels_last)


@contextlib.contextmanager
def kink_sides(sides: list, replay: bool):
    """While active, ``F.relu``, ``F.leaky_relu`` and ``F.max_pool2d``, the
    only functions of the model whose gradient jumps, take their kinks on
    recorded sides: without ``replay`` each call appends the side its own
    input takes to ``sides`` (the sign of each input, the argmax of each
    pool window); with ``replay`` each call takes the next recorded side
    instead.  Yields ``[flips, sides]``: how many recorded sides the calls'
    own inputs would have left, of how many."""
    relu, leaky, pool = F.relu, F.leaky_relu, F.max_pool2d
    recorded, counts = iter(sides), [0, 0]

    def side(own):
        if not replay:
            sides.append(own.cpu())
            return own
        pinned = next(recorded).to(own.device)
        counts[0] += int((pinned != own).sum())
        counts[1] += pinned.numel()
        return pinned

    def pinned_relu(x, inplace=False):
        return x * side(x > 0).to(x.dtype)

    def pinned_leaky_relu(x, negative_slope=0.01, inplace=False):
        return torch.where(side(x > 0), x, x * negative_slope)

    def pinned_max_pool2d(x, kernel_size, *args, **kwargs):
        _, idx = pool(x, kernel_size, *args, return_indices=True, **kwargs)
        idx = side(idx)
        y = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return y.contiguous(memory_format=torch.channels_last)

    F.relu, F.leaky_relu, F.max_pool2d = pinned_relu, pinned_leaky_relu, pinned_max_pool2d
    try:
        yield counts
    finally:
        F.relu, F.leaky_relu, F.max_pool2d = relu, leaky, pool
    if replay and next(recorded, None) is not None:
        raise SystemExit("a pinned step took fewer kinks than the step it replays")


def witness_grads(make, dev, x, c, mask, t, noise, scaling, dtype, cudnn) -> dict:
    """Phases (l) and (m): the one step's gradients on the card in ``dtype``
    with cuDNN on or off, from the same noised batch (noised on the CPU),
    for the model ``make(device)`` gives: ``{name: grad}``, float64 on the
    CPU."""
    x_pert = q_sample(make_schedule(TIMESTEPS), torch.as_tensor(x), t, noise, scaling)
    model = make(dev).to(dtype)
    x_d, t_d, c_d, noise_d, mask_d = (
        torch.as_tensor(a).to(device=dev, dtype=dtype)
        for a in (x_pert, t.float() / TIMESTEPS, c, noise, mask))
    torch.backends.cudnn.enabled = cudnn
    try:
        eps = model(x_d, t_d, c_d, train=True)
        _, loss = trainer.masked_mean(((eps - noise_d) ** 2).mean(dim=(1, 2, 3)), mask_d)
        loss.backward()
    finally:
        torch.backends.cudnn.enabled = True
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def check_train_step(make, dev, batch, scaling="reference", label="",
                     pin_kinks: bool = False) -> dict:
    """Phases (l) and (m): one train step of the model ``make(device)``
    gives on the card and on the CPU, same ``batch`` (x, c, mask, t,
    noise), with the witness of the same step on the card in float64 and in
    fp32 without cuDNN for the leaves beyond ``TRAIN_REL``; then the guard:
    the card's model refuses a grad-enabled forward through the kernels.
    ``pin_kinks`` (phase (m)): every fp32 step takes its kinks on the
    sides the float64 step took (:func:`kink_sides`).  Returns the CPU
    step's loss, per-sample MSE, gradients and running statistics, the
    fp32 reference of phase (o)'s bf16 step."""
    x, c, mask, t, noise = batch
    sides = []

    def kinks(replay):
        return kink_sides(sides, replay) if pin_kinks else contextlib.nullcontext([0, 0])

    with kinks(replay=False):
        ref = witness_grads(make, dev, x, c, mask, t, noise, scaling, torch.float64, True)
    models, losses, flips = [], [], {}
    for name, device in (("card", dev), ("CPU", torch.device("cpu"))):
        model = make(device)
        state = trainer.create_train_state(model, 1e-4, 2, 14)
        with kinks(replay=True) as flips[name]:
            m = trainer.make_train_step(model, TIMESTEPS, scaling)(state, x, c, mask, t=t,
                                                                   noise=noise)
        losses.append(float(m["loss"]))
        cpu_per_sample = m["per_sample_mse"].double().cpu()
        models.append(model)
        del state
    with kinks(replay=True) as flips["no cuDNN"]:
        no_cudnn = witness_grads(make, dev, x, c, mask, t, noise, scaling, torch.float32,
                                 False)
    if pin_kinks:
        print(f"  {label}kinks pinned to the float64 step's sides: " + ", ".join(
            f"{k} fp32 {f[0]} of {f[1]} the other way" for k, f in flips.items()))
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    n_pad = int((np.asarray(mask) == 0).sum())
    print(f"  {label}train step, batch {len(x)} ({n_pad} pad rows masked), "
          f"card vs CPU: loss {losses[0]:.8f} / {losses[1]:.8f}, rel {rel:.3e} "
          f"(tol {TRAIN_REL:g})")
    if not rel <= TRAIN_REL:
        raise SystemExit(f"train step loss on the card vs the CPU: rel {rel} > {TRAIN_REL}")
    grads = [{n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}
             for m in models]
    total = torch.cat([g.flatten() for g in grads[1].values()])
    diff = torch.cat([(grads[0][n] - g).flatten() for n, g in grads[1].items()])
    rel_all = (diff.norm() / total.norm()).item()
    witness = {"card": grads[0], "CPU": grads[1], "no cuDNN": no_cudnn}

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item() if b.norm() > 0 else float("inf")

    def flat(tree):
        return torch.cat([tree[n].flatten() for n in ref])

    print("  gradients vs the card's float64 step, all leaves together: " + ", ".join(
        f"{k} fp32 rel L2 {rel(flat(v), flat(ref)):.3e}" for k, v in witness.items()))
    worst, failed, on_abs, witnessed = (0.0, ""), [], [], []
    for name, g in grads[1].items():
        d = grads[0][name] - g
        rel_leaf = rel(grads[0][name], g)
        max_abs = d.abs().max().item()
        if rel_leaf > worst[0]:
            worst = (rel_leaf, f"{name} rel {rel_leaf:.3e} max abs {max_abs:.3e} "
                               f"(norm {g.norm().item():.3e})")
        if rel_leaf <= TRAIN_REL:
            continue
        line = f"{name} rel {rel_leaf:.3e} max abs {max_abs:.3e} norm {g.norm().item():.3e}"
        if max_abs <= LEAF_ABS and g.norm() <= ROUNDING * total.norm():
            on_abs.append(line)
            continue
        vs64 = {k: rel(v[name], ref[name]) for k, v in witness.items()}
        line += "; vs float64: " + ", ".join(f"{k} {e:.3e}" for k, e in vs64.items())
        if (max_abs <= LEAF_ABS and rel_leaf <= SMALL_LEAF_REL
                and vs64["no cuDNN"] <= TRAIN_REL):
            witnessed.append(line)
        else:
            failed.append(line)
    print(f"  gradients card vs CPU: all {len(grads[1])} leaves together rel L2 "
          f"{rel_all:.3e} (tol {TRAIN_REL:g}), total norm {total.norm().item():.3e}; "
          f"worst leaf {worst[1]}; {len(on_abs)} leaves at rounding level held on max abs "
          f"{LEAF_ABS:g}; {len(witnessed)} held on the float64 witness:")
    for line in on_abs + witnessed:
        print(f"    {line}")
    if not rel_all <= TRAIN_REL or failed:
        raise SystemExit(f"train step gradients on the card vs the CPU: together "
                         f"{rel_all}; leaves beyond rel {TRAIN_REL}, abs {LEAF_ABS} and "
                         f"the float64 witness: {failed[:5]}")
    stats = max((a.double().cpu() - b.double()).abs().max().item()
                for (n, a), b in zip(models[0].named_buffers(), models[1].buffers())
                if n.endswith(("running_mean", "running_var")))
    print(f"  BatchNorm running statistics card vs CPU: max abs {stats:.3e} "
          f"(tol {STATS_TOL:g})")
    if not stats <= STATS_TOL:
        raise SystemExit(f"running statistics on the card vs the CPU: {stats} > {STATS_TOL}")
    model = models[0]
    x_dev = torch.tensor(x[:2], device=dev)
    try:
        model(x_dev, torch.full((2,), 0.5, device=dev), torch.tensor(c[:2], device=dev))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"  guard: a grad-enabled forward through the kernels raised: {e}")
    else:
        raise SystemExit("a grad-enabled forward through the kernels did not raise")
    return {"loss": losses[1], "per_sample": cpu_per_sample, "grads": grads[1],
            "stats": {n: b.double() for n, b in models[1].named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def fixed_objective(dev):
    """Phase (l): ``FIXED_STEPS`` Adam steps at lr 1e-3 from a fresh init on
    one fixed batch, t and noise: ``(model, state, step, batch, losses)``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ContextUnet()
    model = model.to(device=dev, memory_format=torch.channels_last)
    state = trainer.create_train_state(model, 1e-3, 1, 10 * FIXED_STEPS)
    step = trainer.make_train_step(model, TIMESTEPS)
    batch = [torch.as_tensor(a).to(dev) for a in train_batch(1)]
    x, c, mask, t, noise = batch
    losses = [step(state, x, c, mask, t=t, noise=noise)["loss"] for _ in range(FIXED_STEPS)]
    return model, state, step, batch, [float(v) for v in losses]


def time_train_steps(dev, state, step, batch, timed=TIMED_STEPS, profiled=5) -> dict:
    """Phases (l) and (m): ms per train step at batch 32 (CUDA events
    around ``timed`` steps after the warm-up), steps/s, peak device memory,
    and the device time by kernel of ``profiled`` steps under
    ``torch.profiler``.  The
    steps draw t and the noise from their own generator, as
    ``run_experiment``'s do; the batch stays on the card (a run stages the
    next batch on a side stream meanwhile)."""
    x, c, mask = batch[:3]
    step(state, x, c, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        step(state, x, c, mask)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / timed
    peak = torch.cuda.max_memory_allocated(dev)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            step(state, x, c, mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / profiled * 1e3

    def device_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    if not kernels:
        raise SystemExit("the profiler recorded no device time")
    busy = sum(device_us(e) for e in kernels) / profiled / 1e3
    convs = sum(device_us(e) for e in kernels
                if any(k in e.key.lower() for k in CONV_KERNELS)) / profiled / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:5]
    return {"ms": ms, "steps_per_s": 1e3 / ms, "peak_bytes": peak, "busy_ms": busy,
            "profiled_ms": wall, "conv_ms": convs,
            "top": [(e.key, device_us(e) / profiled / 1e3) for e in top]}


def print_train_time(label: str, tr: dict, precision: str = "fp32 with TF32 off") -> None:
    print(f"  {label}train step, batch {TRAIN_BATCH}, {precision}: {tr['ms']:.3f} ms "
          f"({tr['steps_per_s']:.2f} steps/s); peak device memory "
          f"{tr['peak_bytes'] / 2**30:.3f} GiB; under the profiler {tr['profiled_ms']:.3f} "
          f"ms a step, device busy {tr['busy_ms']:.3f} ms (idle share "
          f"{1 - tr['busy_ms'] / tr['profiled_ms']:.3f}), convolution kernels "
          f"{tr['conv_ms']:.3f} ms ({tr['conv_ms'] / tr['busy_ms'] * 100:.1f}% of busy)")
    for name, ms in tr["top"]:
        print(f"    {ms:.3f} ms a step ({ms / tr['busy_ms'] * 100:.1f}% of busy)  {name[:110]}")


def reread_bytes(x, groups: int) -> int:
    """Bytes K2 reads again for NHWC ``x``: in the narrow kernel's wide
    layout the packs of every round but a thread's last, by the output
    pass (from L2 where a wave's parts fit it); on the pair on one card all
    of x, by the apply launch.  The other launches hold every slice on
    chip."""
    n, h, w, c = x.shape
    name, plan = groupnorm_route(n, h * w, c, groups, x.dtype)
    if name == GROUPNORM_NARROW_NAME and plan.wide:
        vs = plan.seg * (c // groups) // 8
        step = plan.threads // vs
        packs = 0  # read again, a unit's
        for rank in range(plan.cluster):
            p0 = min(h * w, rank * plan.part_px)
            npx = min(h * w, p0 + plan.part_px) - p0
            for first in range(step):
                rows = len(range(first, npx, step))
                packs += vs * (-(-rows // plan.packs) - 1) * plan.packs if rows else 0
        return n * groups // plan.seg * packs * 16
    if name in GROUPNORM_PAIR_NAMES.values():  # the apply launch reads x again
        return x.numel() * x.element_size()
    return 0


def variant_model(name: str) -> ContextUnet:
    """The deep or big model at full width on the CPU, its init drawn under
    a fixed seed."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(VARIANT_SEED)
        return getattr(ContextUnet, name)().to(memory_format=torch.channels_last)


def variant_batch(model, n: int, seed: int):
    """``n`` maps in [-1, 1) at the model's size with contexts, no pad rows,
    and injected t and noise."""
    rs = np.random.RandomState(seed)
    size = model.height
    x = (rs.rand(n, size, size, 1) * 2 - 1).astype(np.float32)
    c = rs.rand(n, model.n_cfeat).astype(np.float32)
    t = rs.randint(1, TIMESTEPS + 1, n)
    noise = rs.randn(n, size, size, 1).astype(np.float32)
    return x, c, np.ones(n, np.float32), torch.tensor(t), torch.tensor(noise)


def variant_kinds(n_feat: int, height: int) -> dict:
    """Launches a step and a forward (no CFG) of the fp32 kernels of their
    own that a variant's heads take (``drive(..., kinds=)``): K2's
    large-slice kernel at out_norm, K1's band kernel at the step, where
    the routes give them the shapes (they depend on the batch in neither)."""
    k2 = groupnorm_route(1, height * height, n_feat, 8, torch.float32)[0] == GROUPNORM_LARGE_NAME
    k1 = head_step_route(1, height, height, n_feat, torch.float32, cfg=False)[0] == F32_BAND_NAME
    return {"groupnorm_act_large": (int(k2), int(k2)), "head_step_band": (int(k1), 0)}


def check_variant(name: str, dev, drive) -> dict:
    """Phase (m): the deep or big model at full width.  Its forward on the
    card against the CPU at batch 2; one train step card vs CPU under
    phase (l)'s gate; four exact-chain steps card vs CPU under injected z;
    ``VARIANT_STEPS`` strided steps at ``VARIANT_BATCH`` maps and the
    likelihood forwards of one ELBO batch with their launch counts; the
    train step's time, idle share and peak memory at batch 32, without
    remat."""
    cpu = variant_model(name)
    scaling = "standard" if name == "big" else "reference"  # main.py:156
    n_params = sum(p.numel() for p in cpu.parameters())
    print(f"  {name}: n_feat {cpu.n_feat}, n_cfeat {cpu.n_cfeat}, {cpu.height}x{cpu.height}, "
          f"{cpu.levels} levels, {cpu.up0_norm.act} heads, tanh output, "
          f"{n_params} parameters", flush=True)

    def make(device):
        return copy.deepcopy(cpu).to(device=device, memory_format=torch.channels_last)

    gpu = make(dev).eval()
    cpu.eval()
    x, c, _, t, _ = variant_batch(cpu, VARIANT_CHECK_BATCH, 1)
    t_norm = t.float() / TIMESTEPS
    with torch.inference_mode():
        eps_card = gpu(torch.tensor(x, device=dev), t_norm.to(dev), torch.tensor(c, device=dev))
        eps_cpu = cpu(torch.tensor(x), t_norm, torch.tensor(c))
    err = (eps_card.cpu() - eps_cpu).abs().max().item()
    print(f"  {name} forward, batch {VARIANT_CHECK_BATCH}, card vs CPU: max abs err {err:.3e} "
          f"(tol {VARIANT_TOL:g}; |eps| <= 1)", flush=True)
    if not err <= VARIANT_TOL:
        raise SystemExit(f"{name} forward on the card vs the CPU: {err} > {VARIANT_TOL}")
    check_train_step(make, dev, variant_batch(cpu, VARIANT_CHECK_BATCH, 2), scaling,
                     label=f"{name} ", pin_kinks=True)
    check_sampler_vs_cpu((gpu, cpu), [1, 2, 3, 4], "beta", f"{name} exact chain w=0",
                         size=cpu.height, guide_w=0.0)
    schedule = make_schedule(TIMESTEPS)
    taus = ddim_timesteps(TIMESTEPS, VARIANT_STEPS)

    def sample():
        return sample_ddim(
            gpu, schedule, torch.Generator(device=dev).manual_seed(4), n_sample=VARIANT_BATCH,
            size=cpu.height, params=np.zeros((VARIANT_BATCH, cpu.n_cfeat), np.float32),
            taus=taus, sigma_mode="beta", device=dev)

    kinds = variant_kinds(cpu.n_feat, cpu.height)
    if not kinds["groupnorm_act_large"][0]:
        raise SystemExit(f"{name}: its out_norm does not take the large-slice kernel")
    maps = drive(f"{name}_sampler", sample, steps=len(taus), kinds=kinds)
    check_maps(maps, VARIANT_BATCH, f"{name} sampler", cpu.height)
    t1 = time.perf_counter()  # the same call again, warm
    sample()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / len(taus) * 1e3
    print(f"  {name} sampler: {VARIANT_BATCH} maps, {len(taus)} strided steps, {step_ms:.3f} "
          f"ms a step (host clock, warm)")
    elbo = drive(f"{name}_elbo", lambda: elbo_bpd_batch(
        gpu, schedule, x, c, torch.Generator(device=dev).manual_seed(5), device=dev),
        forwards=10, kinds=kinds)
    if not bool(torch.isfinite(elbo).all()):
        raise SystemExit(f"{name} ELBO: {elbo}")
    del gpu
    torch.cuda.empty_cache()
    batch = [torch.as_tensor(a).to(dev) for a in variant_batch(cpu, TRAIN_BATCH, 3)]
    model = make(dev)
    state = trainer.create_train_state(model, 1e-4, 2, 14)
    step = trainer.make_train_step(model, TIMESTEPS, scaling)
    tr = time_train_steps(dev, state, step, batch, *VARIANT_TIMED[name])
    del model, state, step
    torch.cuda.empty_cache()
    print_train_time(f"{name} ", tr)


def compare_train_states(path_a: str, path_b: str) -> float:
    """Max abs difference over params, batch_stats and Adam moments of two
    train checkpoints; their step and epoch must be equal."""
    with open(path_a, "rb") as f:
        a = _msgpack.unpackb(f.read())
    with open(path_b, "rb") as f:
        b = _msgpack.unpackb(f.read())
    if (a["step"], a["epoch"]) != (b["step"], b["epoch"]):
        raise SystemExit(f"resumed run at step {b['step']} epoch {b['epoch']}, the unbroken "
                         f"run at {a['step']} {a['epoch']}")

    def leaves(tree):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from leaves(tree[key])
            else:
                yield np.asarray(tree[key], np.float64)

    trees = [[t["params"], t["batch_stats"], t["opt_state"]["0"]["mu"],
              t["opt_state"]["0"]["nu"]] for t in (a, b)]
    return max(float(np.abs(x - y).max()) for ta, tb in zip(*trees)
               for x, y in zip(leaves(ta), leaves(tb)))


def check_artifacts(output_dir: str, rel_paths, label: str) -> None:
    """Fail unless a run wrote each of ``rel_paths`` under ``output_dir``."""
    for rel_path in rel_paths:
        if not os.path.exists(os.path.join(output_dir, rel_path)):
            raise SystemExit(f"run_experiment {label} wrote no {rel_path}")


def sampler_calls(cfg) -> int:
    """Sampler chains a run of ``cfg`` drives: the reconstruction (or
    sampling from noise), and in a conditional mode the parameter grid,
    the guidance sweep (one for the w <= 0 strengths and one for the w > 0
    ones) and the sensitivity rows."""
    spec = cfg.spec
    guidance = [any(w <= 0 for w in cfg.guidance_strengths),
                any(w > 0 for w in cfg.guidance_strengths)]
    return 1 + spec.conditional * (
        spec.param_grid + spec.guidance_sweep * sum(guidance)
        + (spec.sensitivity and cfg.num_params > 0))


def check_runs(dev, drive) -> None:
    """Phase (n): ``run_experiment`` of modes ``initial`` (deep), ``main``
    (big) and ``paper`` (canonical: the parameter grid, the guidance sweep
    and the sensitivity rows with their post metrics) on the synthetic
    stand-ins, cut to ``RUN_T`` timesteps, ``RUN_EPOCHS`` epoch(s) and
    ``RUN_MAPS`` maps, each driven with its launch counts
    (:func:`sampler_calls` chains of ``RUN_T`` steps, the likelihood
    forwards counted by their convs to the image channels); the conditional
    run's artifacts."""
    for mode in ("initial", "main", "paper"):
        cfg = ExperimentConfig(mode=mode, lrate=1e-4, n_epoch=RUN_EPOCHS, timesteps=RUN_T,
                               max_maps=RUN_MAPS[mode],
                               output_root=os.path.join(OUT_DIR, f"exp_{mode}"))
        shutil.rmtree(cfg.output_root, ignore_errors=True)
        n_maps = min(cfg.synthetic_param_sets, max(1, RUN_MAPS[mode] // 15)) * 15
        n_train = n_maps - min(cfg.test_size, max(n_maps // 10, 1))
        variant = cfg.spec.model_variant
        t1 = time.perf_counter()
        res = drive(f"run_experiment_{mode}",
                    lambda cfg=cfg: experiment.run_experiment(cfg, device=dev),
                    steps=RUN_T * sampler_calls(cfg), forwards=None,
                    train_forwards=RUN_EPOCHS * num_batches(n_train, cfg.batch_size),
                    kinds=variant_kinds(cfg.n_feat, cfg.height))
        logs = res["loss_log"] + res["val_loss_log"]
        print(f"  run_experiment {mode} ({variant}, n_feat {cfg.n_feat}, {cfg.height}x"
              f"{cfg.height}, T {RUN_T}, {RUN_EPOCHS} epoch): "
              f"{res['data_source']} data, {res['n_train']} train maps, losses {logs}, "
              f"reconstructed mean {res['means']['reconstructed']:.6f}, not ported "
              f"{res['not_ported']}, {len(res['figures_skipped'])} figures skipped (matplotlib "
              f"{'absent' if NO_MATPLOTLIB else 'present'}), in "
              f"{time.perf_counter() - t1:.3f} s", flush=True)
        if (res["n_train"] != n_train or not np.isfinite(logs).all()
                or not np.isfinite(res["means"]["reconstructed"])
                or res["not_ported"] != [] or bool(res["figures_skipped"]) != NO_MATPLOTLIB):
            raise SystemExit(f"run_experiment {mode}: {res['n_train']} train maps, losses "
                             f"{logs}, means {res['means']}, not ported {res['not_ported']}, "
                             f"figures skipped {res['figures_skipped']}")
        if mode == "paper":
            check_artifacts(res["output_dir"], (
                "weights/model_epoch_1.msgpack", "weights/train_state.msgpack",
                "dataset_info.txt", "selected_params.txt", "param_min.npy", "param_max.npy",
                "output.log", "timing_and_performance.log"), mode)
            metrics = [res["recon_metrics"], res["grid_metrics"], *res["guidance_metrics"]]
            if not all(np.isfinite([m["elbo"], m["bpd"], m["nll"]]).all() for m in metrics):
                raise SystemExit(f"run_experiment paper: post metrics {metrics}")
            with open(os.path.join(res["output_dir"], "timing_and_performance.log")) as f:
                log = f.read()
            for line in ("Generating 25 parameter grid samples took",
                         "ELBO of parameter grid samples:", "Guidance strength 5.0 - ELBO:",
                         "Parameter 6 sensitivity metrics:", "  Value 1.00 - ELBO:"):
                if line not in log:
                    raise SystemExit(f"run_experiment paper: no line {line!r} in its log")
            print(f"  paper: grid {res['grid_metrics']}; guidance "
                  f"{[(m['guidance'], round(m['nll'], 3)) for m in res['guidance_metrics']]}")


def check_nov26(dev, drive, dtype: str) -> str:
    """Phases (l2) and (o): ``run_experiment("nov26", 1e-4, 2 epochs, T
    1500)`` in ``dtype`` on the synthetic data (its reconstruction the
    exact chain on 4 maps; no stage follows it), then a run resumed from its
    epoch-1 train checkpoint against its epoch-2 state (cuDNN's
    deterministic algorithms for both), each driven with its launch
    counts.  Returns the unbroken run's train checkpoint."""
    snapshots = os.path.join(OUT_DIR, f"train_state_by_epoch_{dtype}")
    os.makedirs(snapshots, exist_ok=True)
    save = experiment.save_train_checkpoint

    def save_and_keep(state, epoch, path):
        save(state, epoch, path)
        shutil.copy(path, os.path.join(snapshots, f"epoch_{epoch}.msgpack"))

    experiment.save_train_checkpoint = save_and_keep
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the resumed run must retrace the first
    try:
        runs = {}
        for name, resume, epochs in (("exp_a", False, 2), ("exp_b", True, 1)):
            name += "" if dtype == "float32" else "_bf16"
            cfg = ExperimentConfig(mode="nov26", lrate=1e-4, n_epoch=2,
                                   timesteps=TIMESTEPS, n_eval_images=4,
                                   ckpt_every=1, resume=resume, dtype=dtype,
                                   output_root=os.path.join(OUT_DIR, name))
            shutil.rmtree(cfg.output_root, ignore_errors=True)
            if resume:  # the epoch-1 train checkpoint of the unbroken run
                os.makedirs(os.path.join(cfg.output_dir(), "weights"))
                shutil.copy(os.path.join(snapshots, "epoch_1.msgpack"),
                            os.path.join(cfg.output_dir(), "weights", "train_state.msgpack"))
            t1 = time.perf_counter()
            res = drive(f"run_experiment{'_resume' if resume else ''}"
                        + ("" if dtype == "float32" else "_bf16"),
                        lambda cfg=cfg: experiment.run_experiment(cfg, device=dev),
                        steps=TIMESTEPS * sampler_calls(cfg), train_forwards=14 * epochs,
                        dtype=dtype)
            runs[name] = res
            logs = res["loss_log"]
            print(f"  run_experiment {name}: {res['data_source']} data, {res['n_train']} train "
                  f"maps, epochs {res['epoch_times']} s, losses {logs}, reconstructed mean "
                  f"{res['means']['reconstructed']:.6f}, in {time.perf_counter() - t1:.3f} s")
            if not (np.isfinite(logs).all() and np.isfinite(res["means"]["reconstructed"])):
                raise SystemExit(f"run_experiment {name}: losses {logs}, means {res['means']}")
    finally:
        experiment.save_train_checkpoint = save
        torch.backends.cudnn.deterministic = cudnn_deterministic
    out_a, out_b = (runs[k + ("" if dtype == "float32" else "_bf16")]["output_dir"]
                    for k in ("exp_a", "exp_b"))
    state_a = os.path.join(out_a, "weights", "train_state.msgpack")
    check_artifacts(out_a, ("weights/model_epoch_0.msgpack", "weights/model_epoch_1.msgpack",
                            "weights/train_state.msgpack", "output.log"), "nov26")
    diff = compare_train_states(state_a,
                                os.path.join(out_b, "weights", "train_state.msgpack"))
    print(f"  resumed from the epoch-1 train checkpoint vs the unbroken run at epoch 2: "
          f"params, batch_stats and Adam moments max abs {diff:.3e} (tol {RESUME_TOL:g})")
    if not diff <= RESUME_TOL:
        raise SystemExit(f"resumed run vs the unbroken run: {diff} > {RESUME_TOL}")
    return state_a


def check_train_step_bf16(variables, dev, batch, ref: dict) -> None:
    """Phase (o): one train step of the unfolded full-width model computing
    in bf16 (fp32 parameters) from the committed checkpoint, phase (l)'s
    batch, on the card and on the CPU; gated by the CPU's bf16 distance from
    its fp32 step ``ref`` (phase (l)'s CPU step): the per-sample MSE and the
    loss by the largest sample's, the gradients in L2 together and each
    leaf (its yardstick no less than the whole gradient's relative one
    applied to it, as ``tests/test_torch_port_bf16.py`` holds them), and
    the running statistics in L2 together; then its time, idle share and
    peak memory at batch 32."""
    x, c, mask, t, noise = batch
    out = {}
    for name, device in (("card", dev), ("CPU", torch.device("cpu"))):
        model = training_model(variables, device, torch.bfloat16)
        state = trainer.create_train_state(model, 1e-4, 2, 14)
        m = trainer.make_train_step(model, TIMESTEPS)(state, x, c, mask, t=t, noise=noise)
        if m["loss"].dtype != torch.float32 or any(
                p.dtype != torch.float32 for p in model.parameters()):
            raise SystemExit("bf16 train step: the loss or a parameter is not fp32")
        out[name] = {
            "loss": float(m["loss"]), "per_sample": m["per_sample_mse"].double().cpu(),
            "grads": {n: p.grad.double().cpu() for n, p in model.named_parameters()},
            "stats": {n: b.double().cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}
        del model, state
    card, cpu = out["card"], out["CPU"]
    yard = (cpu["per_sample"] - ref["per_sample"]).abs().max().item()
    err = max((card["per_sample"] - cpu["per_sample"]).abs().max().item(),
              abs(card["loss"] - cpu["loss"]))
    print(f"  bf16 train step, batch {len(x)}: loss card {card['loss']:.8f} CPU "
          f"{cpu['loss']:.8f} (fp32 {ref['loss']:.8f}); per-sample MSE and loss card vs CPU "
          f"max abs {err:.3e} (tol {BF16_FACTOR:g} x the CPU's bf16 vs fp32 {yard:.3e})")
    if not err <= BF16_FACTOR * yard:
        raise SystemExit(f"bf16 train step loss: {err} > {BF16_FACTOR} x {yard}")

    def l2(a, b, names):
        return torch.cat([(a[n] - b[n]).flatten() for n in names]).norm().item()

    names = sorted(cpu["grads"])
    full = torch.cat([ref["grads"][n].flatten() for n in names]).norm().item()
    yard = l2(cpu["grads"], ref["grads"], names)
    err = l2(card["grads"], cpu["grads"], names)
    rho = yard / full
    worst = max(((l2(card["grads"], cpu["grads"], [n])
                  / max(l2(cpu["grads"], ref["grads"], [n]), rho * ref["grads"][n].norm().item()),
                  n) for n in names))
    stats = sorted(cpu["stats"])
    s_err, s_yard = l2(card["stats"], cpu["stats"], stats), l2(cpu["stats"], ref["stats"], stats)
    print(f"  bf16 gradients card vs CPU: together L2 {err:.3e} (tol {BF16_FACTOR:g} x the "
          f"CPU's bf16 vs fp32 {yard:.3e}, {rho:.3e} of the gradient); worst leaf "
          f"{worst[1]} at {worst[0]:.3f} of its yardstick (tol {BF16_FACTOR:g}); running "
          f"statistics L2 {s_err:.3e} (tol {BF16_FACTOR:g} x {s_yard:.3e})")
    if not (err <= BF16_FACTOR * yard and worst[0] <= BF16_FACTOR
            and s_err <= BF16_FACTOR * s_yard):
        raise SystemExit("bf16 train step on the card vs the CPU: beyond the yardsticks")
    model = training_model(variables, dev, torch.bfloat16)
    state = trainer.create_train_state(model, 1e-4, 2, 14)
    step = trainer.make_train_step(model, TIMESTEPS)
    print_train_time("bf16 ", time_train_steps(dev, state, step,
                                               [torch.as_tensor(a).to(dev) for a in batch]),
                     "bf16 compute, fp32 parameters and Adam, TF32 off")


def print_rounding(dev) -> None:
    """Phase (o), information: how bf16 convs at the canonical model's width
    (128 to 128 channels, 3x3, 64x64) round on the card and on the CPU,
    against the float64 conv of the same bf16 operands: the share of
    outputs that are the nearest bf16 value, and the mean error toward
    zero in bf16 ulps (0 for rounding to nearest, about 0.5 for
    truncation).  F.conv2d without a bias, with it (cuDNN fuses it), and
    the port's bf16 ``Conv2d`` (the conv, then + bias, each rounded to
    nearest: two roundings, so not always the nearest value of the exact
    sum, but unbiased)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(8, 128, 64, 64, generator=g).bfloat16()
    w = (torch.randn(128, 128, 3, 3, generator=g) / 34).bfloat16()
    b = torch.randn(128, generator=g).bfloat16()
    port = Conv2d(128, 128, 3, padding=1, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        port.weight.copy_(w.float())
        port.bias.copy_(b.float())
    for label, bias in (("F.conv2d, no bias", None), ("F.conv2d with bias", b),
                        ("the port's Conv2d", b)):
        exact = F.conv2d(x.double(), w.double(), None if bias is None else bias.double(),
                         padding=1)
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-126))) - 7)
        parts = []
        for where, device in (("card", dev), ("CPU", torch.device("cpu"))):
            xd = x.to(device, memory_format=torch.channels_last)
            with torch.no_grad():
                if label.startswith("the port"):
                    got = port.to(device)(xd)
                else:
                    got = F.conv2d(xd, w.to(device), None if bias is None else bias.to(device),
                                   padding=1)
            got = got.double().cpu()
            nearest = (got == exact.to(torch.bfloat16).double()).double().mean().item()
            toward_zero = ((exact - got) * exact.sign() / ulp).mean().item()
            parts.append(f"{where} {nearest:.4f} nearest, {toward_zero:+.3f} ulp toward zero")
        print(f"  bf16 conv rounding, {label} (information): " + "; ".join(parts))


def check_bf16(dev, drive, variables, cpu32, served, train_ref) -> None:
    """Phase (o): the bf16 compute path at full width (module docstring);
    ``cpu32`` is the CPU's fp32 serving model, ``served`` phase (e)'s fp32
    maps (the same seed, so the same noise), ``train_ref`` phase (l)'s CPU
    step."""
    bf = torch.bfloat16
    model16 = load_model(variables, dev, dtype=bf)
    cpu16 = load_model(variables, "cpu", dtype=bf)
    check_golden(dev, model16, bf16=True)
    d = np.load(GOLDEN)
    x, t, c = (torch.tensor(d[k], device=dev) for k in ("x", "t", "c"))
    with torch.inference_mode():
        feats = model16.decode_features(model16.encode(x), t, c)
        w, b = model16.out_conv2.weight, model16.out_conv2.bias
        exact = F.conv2d(feats.double(), w.double(), b.double(), padding=1)
        errs = {label: (out.double() - exact).abs().max().item() for label, out in (
            ("cuDNN's bf16 conv", F.conv2d(feats, w, b, padding=1)),
            ("out_conv2 (fp32 sums, one rounding)", model16.out_conv2(feats)))}
    print("  bf16 conv to one channel at full width vs float64 (information): "
          + ", ".join(f"{k} max abs {v:.3e} ({v / bf16_ulp(exact.abs().max().item()):.2f} ulp "
                      f"of max |eps|)" for k, v in errs.items()))
    print_rounding(dev)
    served16 = {}
    for w, steps in ((2, 500), (0, 430)):
        r = drive(f"serve_bf16_w{w}",
                  lambda w=w: serve(w, BATCH, OUT_DIR, seed=0, device=dev,
                                    params=certification_contexts(BATCH), dtype=bf),
                  steps=steps, dtype="bfloat16")
        check_maps(r["maps"], BATCH, f"serve bf16 w={w}")
        if r["steps"] != steps or not np.isfinite(r["pk"]).all():
            raise SystemExit(f"serve bf16 w={w}: {r['steps']} steps or non-finite P(k)")
        served16[w] = r
        diff = (r["maps"] - served[w]["maps"]).abs().max().item()
        print(f"  serve bf16 w={w}: {r['config']}, {BATCH} maps in {r['seconds']:.3f} s "
              f"({BATCH / r['seconds'] * 60:.1f} maps/min on this card; fp32 "
              f"{BATCH / served[w]['seconds'] * 60:.1f}); same noise as fp32 (information "
              f"only): largest map difference {diff:.4f}; P(k) vs exact chain, N={BATCH}: "
              f"bf16 {pk_deviation(r['pk'], w)}, fp32 {pk_deviation(served[w]['pk'], w)}",
              flush=True)
    check_sampler_vs_cpu((model16, cpu16, cpu32), [1, 4, 7, 10], "beta", "bf16 strided w=2")
    schedule = make_schedule(TIMESTEPS)
    maps_np = served16[2]["maps"].cpu().numpy()
    elbo, bpd = drive("battery_bf16_w2", lambda: calculate_elbo_and_bpd(
        model16, schedule, [(maps_np, served16[2]["params"])],
        torch.Generator(device=dev).manual_seed(ELBO_SEED), device=dev),
        forwards=10, dtype="bfloat16")
    print(f"  battery bf16 w=2, N={BATCH} bf16-served maps (information only): ELBO "
          f"{elbo:.6g} BPD {bpd:.6g}")
    check_likelihood_vs_cpu(
        (model16, cpu16, cpu32),
        lambda m, x, c, nf: elbo_bpd_batch(m, schedule, x, c, noise_fn=nf, device=on(m)),
        maps_np[:2], served16[2]["params"][:2], 10, "bf16 ELBO of 2 served w=2 maps")
    del model16, cpu16
    torch.cuda.empty_cache()
    check_bf16_narrow(dev, drive, NARROW_FEAT, "narrow", NARROW_PER_FORWARD, NARROW_PER_STEP)
    check_bf16_narrow(dev, drive, WIDE_FEAT, "wide", WIDE_PER_FORWARD, WIDE_PER_STEP)
    torch.cuda.empty_cache()
    check_train_step_bf16(variables, dev, train_batch(), train_ref)
    torch.cuda.empty_cache()
    check_nov26(dev, drive, "bfloat16")


def check_bf16_narrow(dev, drive, n_feat: int, kind: str, per_forward: dict,
                      per_step: dict) -> None:
    """Phase (o): the canonical model at ``n_feat`` (``NARROW_FEAT`` or
    ``WIDE_FEAT``) from a seeded init, folded in bf16 (module docstring):
    its forward on ``NARROW_MAPS`` maps and four strided w=2 steps on the
    card against the CPU's bf16, within ``BF16_FACTOR`` x the CPU's bf16
    distance from its fp32, each driven as the paths ``{kind}_bf16_forward``
    and ``{kind}_bf16_steps`` with the narrow launches ``per_forward`` and
    ``per_step`` (no float kernel's bf16 instance)."""
    bf = torch.bfloat16
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(VARIANT_SEED)
        variables = to_jax_variables(ContextUnet.canonical(n_feat=n_feat).state_dict())
    gpu16 = load_model(variables, dev, dtype=bf)
    cpu16, cpu32 = (load_model(variables, "cpu", dtype=d) for d in (bf, torch.float32))
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(NARROW_MAPS, 64, 64, 1).astype(np.float32))
    t = torch.tensor(rs.rand(NARROW_MAPS).astype(np.float32))
    c = torch.tensor(rs.rand(NARROW_MAPS, cpu16.n_cfeat).astype(np.float32))
    with torch.inference_mode():
        got = drive(f"{kind}_bf16_forward", lambda: gpu16(x.to(dev), t.to(dev), c.to(dev)),
                    forwards=1, dtype="bfloat16", extra=per_forward)
        want, want32 = cpu16(x, t, c), cpu32(x, t, c)
    if got.dtype != bf or want.dtype != bf:
        raise SystemExit(f"n_feat {n_feat} bf16 forward: eps is {got.dtype}, {want.dtype}")
    yard = (want.float() - want32).abs().max().item()
    err = (got.float().cpu() - want.float()).abs().max().item()
    print(f"  n_feat {n_feat} bf16 forward, {NARROW_MAPS} maps, card vs CPU: max abs err "
          f"{err:.3e} (tol {BF16_FACTOR * yard:g} = {BF16_FACTOR:g} x the CPU's bf16 vs fp32 "
          f"{yard:.3e})", flush=True)
    if not err <= BF16_FACTOR * yard:
        raise SystemExit(f"n_feat {n_feat} bf16 forward on the card vs the CPU: {err} > "
                         f"{BF16_FACTOR * yard}")
    taus = [1, 4, 7, 10]
    drive(f"{kind}_bf16_steps", lambda: check_sampler_vs_cpu(
        (gpu16, cpu16, cpu32), taus, "beta", f"n_feat {n_feat} bf16 strided w=2"),
        steps=len(taus), dtype="bfloat16",
        extra={k: len(taus) * v for k, v in per_step.items()})


def check_pair_model(dev, drive, dtype: str) -> None:
    """Phase (s): the canonical model at ``PAIR_FEAT`` (``PAIR_SIZE`` maps,
    seeded init), folded, in ``dtype``: its forward on 2 maps and four
    strided w=2 steps on the card against the CPU (fp32 within
    ``GOLDEN_TOL``; bf16 within ``BF16_FACTOR`` x the CPU's bf16 distance
    from its fp32), driven as the paths ``pair_{dtype}_forward`` and
    ``pair_{dtype}_steps`` with the launches ``PAIR_PER_FORWARD`` and
    ``PAIR_PER_STEP`` beyond a decoder call's (the pair at up0_norm; no
    split K1)."""
    dt = getattr(torch, dtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(VARIANT_SEED)
        variables = to_jax_variables(
            ContextUnet.canonical(n_feat=PAIR_FEAT, height=PAIR_SIZE).state_dict())
    gpu = load_model(variables, dev, dtype=dt)
    cpus = tuple(load_model(variables, "cpu", dtype=d) for d in dict.fromkeys((dt, torch.float32)))
    del variables
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(NARROW_MAPS, PAIR_SIZE, PAIR_SIZE, 1).astype(np.float32))
    t = torch.tensor(rs.rand(NARROW_MAPS).astype(np.float32))
    c = torch.tensor(rs.rand(NARROW_MAPS, gpu.n_cfeat).astype(np.float32))
    with torch.inference_mode():
        got = drive(f"pair_{dtype}_forward", lambda: gpu(x.to(dev), t.to(dev), c.to(dev)),
                    forwards=1, dtype=dtype, extra=PAIR_PER_FORWARD[dtype])
        wants = [m(x, t, c) for m in cpus]
    err = (got.float().cpu() - wants[0].float()).abs().max().item()
    tol, what = GOLDEN_TOL, ""
    if len(cpus) == 2:
        yard = (wants[0].float() - wants[1]).abs().max().item()
        tol, what = BF16_FACTOR * yard, f" = {BF16_FACTOR:g} x the CPU's bf16 vs fp32 {yard:.3e}"
    print(f"  n_feat {PAIR_FEAT} {dtype} forward, {NARROW_MAPS} maps of {PAIR_SIZE}x{PAIR_SIZE}, "
          f"card vs CPU: max abs err {err:.3e} (tol {tol:g}{what})", flush=True)
    if got.dtype != dt or not err <= tol:
        raise SystemExit(f"n_feat {PAIR_FEAT} {dtype} forward on the card vs the CPU: {err} > "
                         f"{tol}, or eps in {got.dtype}")
    taus = [1, 4, 7, 10]
    drive(f"pair_{dtype}_steps", lambda: check_sampler_vs_cpu(
        (gpu,) + cpus, taus, "beta", f"n_feat {PAIR_FEAT} {dtype} strided w=2", size=PAIR_SIZE),
        steps=len(taus), dtype=dtype,
        extra={k: len(taus) * v for k, v in PAIR_PER_STEP[dtype].items()})


def check_channels_model(dev, drive, dtype: str, in_channels: int, paths) -> None:
    """Phase (t): the canonical model of ``in_channels`` image channels
    (n_feat 128, 64x64, n_cfeat 6, seeded init), folded, in ``dtype``:
    four strided w=2 steps (``paths`` "strided") and four posterior DDIM
    steps (eta 0; "posterior") on ``CHANNELS_MAPS`` maps on the card
    against the CPU (``CHANNELS_CPU_MAPS`` of them; fp32 within
    ``GOLDEN_TOL``; bf16 within ``BF16_FACTOR`` x the CPU's bf16 distance
    from its fp32), driven as the paths ``channels_{in_channels}_{dtype}_{path}``:
    ``LAUNCHES_PER_STEP`` a step, each K1 launch at ``in_channels`` output
    channels (in the output-stationary kernel where the route gives it:
    fp32, and bf16 at 13), no conv to the image channels."""
    dt = getattr(torch, dtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(VARIANT_SEED)
        variables = to_jax_variables(ContextUnet.canonical(in_channels=in_channels).state_dict())
    gpu = load_model(variables, dev, dtype=dt)
    cpus = tuple(load_model(variables, "cpu", dtype=d) for d in dict.fromkeys((dt, torch.float32)))
    del variables
    if gpu.in_channels != in_channels or tuple(gpu.out_conv2.weight.shape[:2]) != (
            in_channels, gpu.n_feat):
        raise SystemExit(f"the {in_channels}-channel model loaded with in_channels "
                         f"{gpu.in_channels}")
    kinds = ("cout", "os") if cout_kind(BATCH, 64, 64, gpu.n_feat, dt, in_channels) == "os" \
        else ("cout",)
    extra = {instance(f"head_step_{kind}", dtype): 4 for kind in kinds}
    for path, taus, mode in (("strided", [1, 4, 7, 10], "beta"),
                             ("posterior", ddim_timesteps(TIMESTEPS, 50)[:4], "posterior")):
        if path not in paths:
            continue
        drive(f"channels_{in_channels}_{dtype}_{path}",
              lambda taus=taus, mode=mode: check_sampler_vs_cpu(
                  (gpu,) + cpus, taus, mode, f"{in_channels} image channels {dtype} {path} w=2",
                  maps=CHANNELS_MAPS, cpu_maps=CHANNELS_CPU_MAPS[dtype]), steps=len(taus),
              dtype=dtype, extra=extra)


def check_native_prep() -> None:
    """Phase (p): the port's build of the native prep loads, and its
    ``"code"`` prep (normalise, resize to 64) of a synthetic
    ``PREP_MAPS`` x ``PREP_SIZE``^2 stack against the numpy path: times and
    the largest difference (normalised maps within ``PREP_TOL``)."""
    t1 = time.perf_counter()
    if not native_prep.available():
        raise SystemExit("the native prep library did not build or load")
    print(f"  native prep: {native_prep.library_path()} built and loaded in "
          f"{time.perf_counter() - t1:.3f} s")
    raw, _ = synthetic_camels(n_param_sets=PREP_MAPS // 15, maps_per_set=15, size=PREP_SIZE,
                              seed=0)
    t1 = time.perf_counter()
    nat = native_prep.normalize_maps_native(raw)
    nat64 = native_prep.resize_maps_native(nat, 64)
    native_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ref = normalize_maps(raw, "code").astype(np.float32)
    ref64 = resize_maps_np(ref, 64)
    numpy_s = time.perf_counter() - t1
    err, err64 = float(np.abs(nat - ref).max()), float(np.abs(nat64 - ref64).max())
    print(f"  \"code\" prep of {raw.shape} float32 to 64x64 on the host: native "
          f"{native_s:.3f} s, numpy {numpy_s:.3f} s ({numpy_s / native_s:.2f}x); max abs "
          f"difference normalised {err:.3e} (tol {PREP_TOL:.3e}), resized {err64:.3e}; "
          f"pixels that differ {float(np.mean(nat != ref)):.4f}", flush=True)
    if not err <= PREP_TOL:
        raise SystemExit(f"native vs numpy prep: {err} > {PREP_TOL}")


def stochastic_variables(variables: dict) -> dict:
    """The checkpoint's tree without its learned ``init_conv/shortcut``: a
    stochastic-shortcut model's (the reference's ContextUnet)."""
    params = dict(variables["params"])
    params["init_conv"] = {k: v for k, v in params["init_conv"].items() if k != "shortcut"}
    return {"params": params, "batch_stats": variables["batch_stats"]}


def check_reference_workflow(dev, drive, variables) -> None:
    """Phase (p) (module docstring) on the committed checkpoint's
    ``variables``."""
    check_native_prep()

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        template = to_jax_variables(ContextUnet().state_dict())
    out = os.path.join(OUT_DIR, "sample_cli")
    shutil.rmtree(out, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "reference.pth")
        t1 = time.perf_counter()
        torch_interop.save_torch_checkpoint(variables, pth)
        imported = torch_interop.load_torch_checkpoint(template, pth)
        print(f"  committed checkpoint -> reference .pth ({os.path.getsize(pth) / 2**20:.1f} "
              f"MiB) -> imported in {time.perf_counter() - t1:.3f} s")
        t1 = time.perf_counter()
        res = drive("sample_cli_pth", lambda: sample_cli.generate_comparison_plot(
            model_path=pth, camels_data_path=os.path.join(tmp, "absent.npy"),
            params_path=os.path.join(tmp, "absent.npy"), output_dir=out,
            selected_params_dict=dict(sample_cli.SELECTED_PARAMS), n_maps=CLI_MAPS,
            timesteps=TIMESTEPS, seed=0, serving_steps=0, calibration_path="",
            guide_w=0.0, device=dev), steps=TIMESTEPS)
        seconds = time.perf_counter() - t1
    ratio = res["hicdm_pk_mean"] / res["camels_pk_mean"]
    print(f"  comparison CLI on the .pth: {CLI_MAPS} maps, exact chain of {TIMESTEPS} steps, "
          f"w 0, in {seconds:.3f} s ({CLI_MAPS / seconds * 60:.2f} maps/min, "
          f"{seconds / TIMESTEPS * 1e3:.3f} ms a step, model load and P(k) included); "
          f"mean P(k) ratio HI-CDM/CAMELS {np.mean(ratio):.4f} ± {np.std(ratio):.4f}; "
          f"files {sorted(os.listdir(out))}", flush=True)
    if (not all(np.isfinite(res[k]).all() for k in ("hicdm_pk_mean", "hicdm_pk_std"))
            or not os.path.exists(os.path.join(out, "power_spectrum_results.npy"))):
        raise SystemExit(f"comparison CLI: non-finite spectra or no results file in {out}")

    # The .pth model is the .msgpack one with the learned shortcut re-seeded
    # by threefry (torch_interop.shortcut_seed_draw).
    seeded = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    sc = variables["params"]["init_conv"]["shortcut"]
    kernel, bias = torch_interop.shortcut_seed_draw(sc["kernel"].shape, sc["bias"].shape)
    seeded["params"]["init_conv"] = {**variables["params"]["init_conv"],
                                     "shortcut": {"kernel": kernel, "bias": bias}}
    d = np.load(GOLDEN)
    x, t, c = (torch.tensor(d[k]) for k in ("x", "t", "c"))
    eps = {}
    for name, tree, device in (("pth", imported, dev), ("msgpack_seeded", seeded, dev),
                               ("pth_cpu", imported, "cpu")):
        m = load_model(tree, device)
        with torch.no_grad():
            eps[name] = m(x.to(device), t.to(device), c.to(device)).cpu()
    same = (eps["pth"] - eps["msgpack_seeded"]).abs().max().item()
    cpu = (eps["pth"] - eps["pth_cpu"]).abs().max().item()
    print(f"  .pth model's eps on the card vs the .msgpack model with the threefry shortcut: "
          f"max abs {same:.3e}; vs the .pth model on the CPU {cpu:.3e} (tol {GOLDEN_TOL:g})")
    if not (same <= GOLDEN_TOL and cpu <= GOLDEN_TOL):
        raise SystemExit(f".pth model eps: {same} / {cpu} > {GOLDEN_TOL}")

    # The stochastic shortcut: one draw a model evaluation, injected.
    stoch = stochastic_variables(variables)
    smodels = (load_model(stoch, dev), load_model(stoch, "cpu"))
    if not all(m.stochastic for m in smodels):
        raise SystemExit("the tree without init_conv/shortcut did not load as stochastic")
    rs = np.random.RandomState(5)
    draws = [(torch.tensor(rs.uniform(-1, 1, (128, 1, 1, 1)).astype(np.float32)),
              torch.tensor(rs.uniform(-1, 1, (128,)).astype(np.float32))) for _ in range(10)]
    taus = [1, 2, 3, 4]
    x0 = rs.randn(2, 64, 64, 1).astype(np.float32)
    params = certification_contexts(2)
    zs = [torch.tensor(rs.randn(2, 64, 64, 1).astype(np.float32)) for _ in taus]

    def on_card_driven(path, m, run, **counts):
        """``run()``, driven as ``path`` with its launch counts on the card."""
        return drive(path, run, **counts) if on(m).type == "cuda" else run()

    outs = [on_card_driven("stochastic_exact_steps", m, lambda m=m: sample_ddim(
        m, make_schedule(TIMESTEPS), torch.Generator(device=on(m)), params=params,
        guide_w=2.0, x_init=x0, taus=np.asarray(taus), sigma_mode="beta", device=on(m),
        z_fn=lambda k, t: zs[k], shortcut_fn=lambda k, t: draws[k]),
        steps=len(taus)).cpu() for m in smodels]
    err = (outs[0] - outs[1]).abs().max().item()
    print(f"  stochastic shortcut, exact chain t = 4..1 at w=2 (the strided sampler at "
          f"stride 1), card vs CPU: max abs err {err:.3e} (tol {GOLDEN_TOL:g})", flush=True)
    if not err <= GOLDEN_TOL:
        raise SystemExit(f"stochastic exact steps on the card vs the CPU: {err} > {GOLDEN_TOL}")
    schedule = make_schedule(TIMESTEPS)
    check_likelihood_vs_cpu(
        smodels, lambda m, x, c, nf: on_card_driven("stochastic_elbo", m, lambda: elbo_bpd_batch(
            m, schedule, x, c, noise_fn=nf, shortcut_fn=lambda bi, k, t: draws[k],
            device=on(m)), forwards=10),
        outs[0].numpy(), params, 10, "stochastic shortcut, ELBO of 2 maps")

    cfg = ExperimentConfig(mode="nov26", lrate=1e-4, n_epoch=1, timesteps=TIMESTEPS,
                           n_eval_images=4, shortcut="stochastic",
                           output_root=os.path.join(OUT_DIR, "exp_stochastic"))
    shutil.rmtree(cfg.output_root, ignore_errors=True)
    t1 = time.perf_counter()
    res = drive("run_experiment_stochastic",
                lambda: experiment.run_experiment(cfg, device=dev),
                steps=TIMESTEPS * sampler_calls(cfg), train_forwards=14)
    ckpt = load_variables(os.path.join(res["output_dir"], "weights", "train_state.msgpack"))
    print(f"  run_experiment nov26, shortcut stochastic, 1 epoch, T {TIMESTEPS}: losses "
          f"{res['loss_log']}, reconstructed mean {res['means']['reconstructed']:.6f}, "
          f"in {time.perf_counter() - t1:.3f} s", flush=True)
    if (not np.isfinite(res["loss_log"]).all() or not np.isfinite(res["means"]["reconstructed"])
            or "shortcut" in ckpt["params"]["init_conv"]):
        raise SystemExit(f"run_experiment stochastic: losses {res['loss_log']}, means "
                         f"{res['means']}, init_conv leaves {sorted(ckpt['params']['init_conv'])}")


def mesh_batch(real: int, seed: int = 2):
    """Phase (q2): a full-width batch of ``TRAIN_BATCH`` rows, ``real`` of
    them real and the rest wrap-padded and masked, with the global batch's
    t and noise."""
    rs = np.random.RandomState(seed)
    maps, _ = synthetic_camels(n_param_sets=3, maps_per_set=15, size=64, seed=seed)
    idx = np.arange(TRAIN_BATCH) % real
    x = normalize_maps(maps[:real]).astype(np.float32)[idx, ..., None]
    c = rs.rand(real, 6).astype(np.float32)[idx]
    mask = (np.arange(TRAIN_BATCH) < real).astype(np.float32)
    t = rs.randint(1, TIMESTEPS + 1, TRAIN_BATCH)
    noise = rs.randn(TRAIN_BATCH, 64, 64, 1).astype(np.float32)
    return x, c, mask, t, noise


def mesh_rows(mesh, x, c, mask):
    """This process's part of a batch: all of it, its rows on a 1-D mesh,
    its (batch, height) block of ``x`` on a 2-D one."""
    if mesh is None:
        return x, c, mask
    if isinstance(mesh, Mesh2D):
        return shard_batch_spatial(mesh, x, c, mask)
    return shard_batch(mesh, x, c, mask)


def mesh_step(variables, dev, batch, mesh=None) -> dict:
    """Phase (q2): one train step of the unfolded full-width model holding
    ``variables`` on ``batch`` (t and noise injected), in one process or
    over ``mesh`` on this rank's rows: loss, gradients and running
    statistics, on the host."""
    x, c, mask, t, noise = batch
    model = training_model(variables, dev)
    state = trainer.create_train_state(model, 1e-4, 2, 14)
    rows = mesh_rows(mesh, x, c, mask)
    m = trainer.make_train_step(model, TIMESTEPS, mesh=mesh)(
        state, *rows, t=torch.tensor(t), noise=torch.tensor(noise))
    return {"loss": float(m["loss"]),
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "stats": {n: b.detach().cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def mesh_sampler(model, dev, mesh=None) -> torch.Tensor:
    """Phase (q2): the strided DDPM at w=2 over ``MESH_STEPS`` steps on
    ``MESH_MAPS`` maps, its draws from a seeded generator on ``dev``."""
    return sample_ddim(model, make_schedule(TIMESTEPS), torch.Generator(device=dev).manual_seed(5),
                       n_sample=MESH_MAPS, params=certification_contexts(MESH_MAPS), guide_w=2.0,
                       n_steps=MESH_STEPS, sigma_mode="beta", device=dev, mesh=mesh)


def time_mesh_steps(variables, dev, batch, mesh=None, warm: int = 1, timed: int = 3) -> float:
    """Phase (q2): ms a train step of ``batch`` (host clock around
    ``timed`` steps after ``warm``, each ended by a synchronize), in one
    process or over ``mesh``."""
    x, c, mask, t, noise = batch
    model = training_model(variables, dev)
    state = trainer.create_train_state(model, 1e-4, 2, 14)
    step = trainer.make_train_step(model, TIMESTEPS, mesh=mesh)
    rows = mesh_rows(mesh, x, c, mask)
    draws = dict(t=torch.tensor(t, device=dev), noise=torch.tensor(noise, device=dev))
    for k in range(warm + timed):
        if k == warm:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        step(state, *rows, **draws)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / timed * 1e3


def grads_digest(grads: dict) -> str:
    """A digest of a step's gradients, bit for bit."""
    h = hashlib.sha256()
    for name, g in grads.items():
        h.update(name.encode())
        h.update(g.contiguous().numpy().tobytes())
    return h.hexdigest()


def mesh_rank(mesh, model_path: str, batches, spawned: float) -> dict:
    """Phase (q2), in each of two ranks sharing the card: the train steps
    of ``batches`` (rank 0's in full, the others' gradients as a digest,
    for they must be rank 0's), the ms of a step of the first, and the
    sampler over the mesh with its launch counts (each rank counts its own
    launches); the seconds of each part, the start-up's from ``spawned``
    (``time.time()`` in the parent)."""
    seconds, t1 = {"start-up": time.time() - spawned}, time.perf_counter()

    def lap(part):
        nonlocal t1
        seconds[part], t1 = time.perf_counter() - t1, time.perf_counter()

    variables = load_variables(model_path)
    lap("load")
    steps = [mesh_step(variables, mesh.device, b, mesh) for b in batches]
    for step in steps:
        step["digest"] = grads_digest(step["grads"])
        if mesh.rank:
            del step["grads"]
    lap("gated steps")
    step_ms = time_mesh_steps(variables, mesh.device, batches[0], mesh)
    lap("timed steps")
    model = load_model(variables, mesh.device)
    for wrapper, count in WRAPPERS.values():
        setattr(wrapper, count, 0)
    maps = mesh_sampler(model, mesh.device, mesh).cpu()
    lap("sampler")
    return {"steps": steps, "maps": maps, "step_ms": step_ms, "seconds": seconds,
            "launches": {name: getattr(w, count) for name, (w, count) in WRAPPERS.items()}}


def hold_mesh_step(label: str, got: dict, want: dict, witness: dict) -> None:
    """Phase (q2): a two-rank train step against the single-process step on
    the card under phase (l)'s gate: loss and all gradients together within
    ``TRAIN_REL``; each leaf within it, or at rounding level (max abs
    ``LEAF_ABS``, norm below ``ROUNDING`` of all gradients'), or held on
    the witness as phase (l) holds it: max abs within ``LEAF_ABS``, error
    within ``SMALL_LEAF_REL``, and the one-process fp32 step without cuDNN
    within ``TRAIN_REL`` of the float64 step (``witness``: ``{"float64":
    grads, "no cuDNN": grads}`` of the one-process step), so that
    the gap is the rounding of cuDNN's algorithms at the ranks' batch of 16
    and of each rank's partial gradient, not the port's math.  Running
    statistics ``STATS_TOL`` abs."""
    rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    total = torch.cat([g.double().flatten() for g in want["grads"].values()])
    diff = torch.cat([(got["grads"][n].double() - g.double()).flatten()
                      for n, g in want["grads"].items()])
    rel_all = (diff.norm() / total.norm()).item()

    def rel_to(a, b):
        return ((a.double() - b).norm() / b.norm()).item() if b.norm() > 0 else float("inf")

    worst, failed, small = (0.0, ""), [], []
    for name, g in want["grads"].items():
        g = g.double()
        d = got["grads"][name].double() - g
        rel_leaf = rel_to(got["grads"][name], g)
        line = f"{name} rel {rel_leaf:.3e} max abs {d.abs().max().item():.3e}"
        worst = max(worst, (rel_leaf, line))
        if rel_leaf <= TRAIN_REL or (d.abs().max() <= LEAF_ABS
                                     and g.norm() <= ROUNDING * total.norm()):
            continue
        f64 = witness["float64"][name]
        no_cudnn = rel_to(witness["no cuDNN"][name], f64)
        line += (f"; vs float64: two ranks {rel_to(got['grads'][name], f64):.3e}, one "
                 f"process {rel_to(g, f64):.3e}, one process without cuDNN {no_cudnn:.3e}")
        if d.abs().max() <= LEAF_ABS and rel_leaf <= SMALL_LEAF_REL and no_cudnn <= TRAIN_REL:
            small.append(line)
        else:
            failed.append(line)
    stats = max((got["stats"][n].double() - v.double()).abs().max().item()
                for n, v in want["stats"].items())
    print(f"  {label}: two ranks vs one process on the card: loss {got['loss']:.8f} / "
          f"{want['loss']:.8f} rel {rel:.3e}; gradients together rel L2 {rel_all:.3e} "
          f"(tol {TRAIN_REL:g}), worst leaf {worst[1]}; {len(small)} leaves beyond "
          f"{TRAIN_REL:g} held on the witness; running statistics max abs {stats:.3e} "
          f"(tol {STATS_TOL:g})", flush=True)
    for line in small:
        print(f"    {line}")
    if not (rel <= TRAIN_REL and rel_all <= TRAIN_REL and not failed and stats <= STATS_TOL):
        raise SystemExit(f"{label}: two ranks vs one process beyond phase (l)'s gate: loss "
                         f"{rel}, gradients {rel_all}, leaves {failed[:5]}, stats {stats}")


def check_mesh_one(dev, drive, nov26_state: str) -> None:
    """Phase (q1): phase (l2)'s ``run_experiment("nov26", T 1500)`` with
    ``mesh_devices=1`` inside an NCCL group of one process (a mesh of one
    runs no collective), its train state against phase (l2)'s mesh-less
    run's: equal (cuDNN's deterministic algorithms for both)."""
    store = tempfile.mkdtemp(dir=OUT_DIR)
    init_distributed(backend="nccl", rank=0, world_size=1,
                     store=torch.distributed.FileStore(os.path.join(store, "store"), 1))
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = ExperimentConfig(mode="nov26", lrate=1e-4, n_epoch=2, timesteps=TIMESTEPS,
                               n_eval_images=4, ckpt_every=1, mesh_devices=1,
                               output_root=os.path.join(OUT_DIR, "exp_mesh1"))
        shutil.rmtree(cfg.output_root, ignore_errors=True)
        t1 = time.perf_counter()
        res = drive("run_experiment_mesh1", lambda: experiment.run_experiment(cfg, device=dev),
                    steps=TIMESTEPS * sampler_calls(cfg), train_forwards=28)
        print(f"  run_experiment nov26, mesh_devices=1 in an NCCL group of "
              f"{torch.distributed.get_world_size()}: losses {res['loss_log']} in "
              f"{time.perf_counter() - t1:.3f} s")
    finally:
        torch.backends.cudnn.deterministic = cudnn_deterministic
        torch.distributed.destroy_process_group()
    diff = compare_train_states(nov26_state, os.path.join(
        res["output_dir"], "weights", "train_state.msgpack"))
    print(f"  train state vs phase (l2)'s mesh-less run: params, batch_stats and Adam "
          f"moments max abs {diff:.3e} (must be 0)")
    if diff != 0.0:
        raise SystemExit(f"the mesh path of one process vs the mesh-less run: {diff}")


def check_mesh_two(dev, variables, model, model_path: str, launches: dict) -> dict:
    """Phase (q2): two gloo ranks sharing the card (module docstring).
    While the ranks start (a process takes seconds to import torch and to
    run its first step on the card), this process takes its own steps,
    their witnesses and its sampler; it times its step once they are
    done, so the card is its own then."""
    batches = [mesh_batch(TRAIN_BATCH), mesh_batch(30)]
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(spawn, mesh_rank, 2, (model_path, batches, time.time()),
                              store_dir=tempfile.mkdtemp(dir=OUT_DIR), backend="gloo",
                              device=dev, timeout=MESH_TIMEOUT)
        wants = [mesh_step(variables, dev, batch) for batch in batches]
        witnesses = [{name: witness_grads(lambda device: training_model(variables, device),
                                          dev, x, c, mask, torch.tensor(t), torch.tensor(noise),
                                          "reference", dtype, cudnn)
                      for name, dtype, cudnn in (("float64", torch.float64, True),
                                                 ("no cuDNN", torch.float32, False))}
                     for x, c, mask, t, noise in batches]
        want = mesh_sampler(model, dev).cpu()
        ranks = pending.result()
    print(f"  two gloo ranks on {dev}: {time.perf_counter() - t1:.3f} s, start-up included "
          f"(rank 0: {', '.join(f'{k} {v:.3f}' for k, v in ranks[0]['seconds'].items())} s); "
          f"a train step of the batch of 32 (16 a rank): "
          f"{', '.join(f'{r['step_ms']:.3f}' for r in ranks)} ms (ranks 0, 1); in one "
          f"process {time_mesh_steps(variables, dev, batches[0]):.3f} ms", flush=True)
    for label, i in (("batch 32 (16 a rank)", 0), ("30 maps padded to 32 (2 pad rows masked)", 1)):
        steps = [r["steps"][i] for r in ranks]
        if steps[1]["digest"] != steps[0]["digest"]:  # summed: one value on both ranks
            raise SystemExit(f"{label}: the ranks' gradients differ")
        hold_mesh_step(label, steps[0], wants[i], witnesses[i])
    want_launches = {name: 0 for name in WRAPPERS}
    want_launches.update({name: MESH_STEPS * n for name, n in LAUNCHES_PER_STEP.items()})
    for r, rank in enumerate(ranks):
        err = (rank["maps"] - want).abs().max().item()
        launches[f"mesh2_strided_w2_rank{r}"] = rank["launches"]
        print(f"  rank {r}: strided DDPM w=2, {MESH_STEPS} steps, {MESH_MAPS} maps over two "
              f"ranks vs one process: max abs {err:.3e} (tol {MESH_TOL:g}); launches "
              f"{rank['launches']}")
        if not err <= MESH_TOL or rank["launches"] != want_launches:
            raise SystemExit(f"rank {r}: sharded sampler {err}, launches {rank['launches']} "
                             f"(expected {want_launches})")
    return {"batch": batches[0], "want": wants[0], "witness": witnesses[0]}


def dpm_inputs(dev) -> tuple:
    """Phase (q3): the contexts and the starting noise (on the card) of its
    ``BATCH`` maps."""
    return certification_contexts(BATCH), torch.randn(
        (BATCH, 64, 64, 1), device=dev, generator=torch.Generator(device=dev).manual_seed(6))


def dpm_on_cpu(variables, cpu32, params, x_init) -> dict:
    """Phase (q3)'s reference: ``sample_dpm2m`` on the CPU on the first
    ``DPM_CPU_MAPS[dtype]`` maps' inputs (``x_init`` on the host), in fp32
    and bf16: ``{dtype: (maps, seconds)}``.  ``main`` runs it in a thread
    beside phase (q1), which runs on the card in fp32: the two share
    ``fp32_math``'s flags, whose TF32 flags this script keeps off anyway, so
    only the bf16 reduction flag can race, and no fp32 run reads it."""
    out = {}
    for dtype, host in (("float32", cpu32),
                        ("bfloat16", load_model(variables, "cpu", dtype=torch.bfloat16))):
        n = DPM_CPU_MAPS[dtype]
        t1 = time.perf_counter()
        maps = sample_dpm2m(host, make_schedule(TIMESTEPS), torch.Generator(), params=params[:n],
                            guide_w=2.0, n_steps=DPM_STEPS, x_init=x_init[:n], device="cpu")
        out[dtype] = (maps, time.perf_counter() - t1)
    return out


def check_dpm(dev, drive, variables, model, params, x_init, cpu: dict) -> None:
    """Phase (q3): ``sample_dpm2m`` at full width on the card, fp32 and
    bf16, against ``cpu`` (:func:`dpm_on_cpu`; module docstring)."""
    schedule = make_schedule(TIMESTEPS)
    for dtype, card in (("float32", model),
                        ("bfloat16", load_model(variables, dev, dtype=torch.bfloat16))):
        suffix = "" if dtype == "float32" else "_bf16"
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        maps = drive(f"dpm2m_w2{suffix}", lambda card=card: sample_dpm2m(
            card, schedule, torch.Generator(device=dev), params=params, guide_w=2.0,
            n_steps=DPM_STEPS, x_init=x_init, device=dev), forwards=DPM_STEPS, dtype=dtype)
        seconds = time.perf_counter() - t1
        n = DPM_CPU_MAPS[dtype]
        check_maps(maps, BATCH, f"DPM-Solver++(2M) {dtype}")
        _, pk = power_spectrum_batch(maps[..., 0])
        ref, cpu_seconds = cpu[dtype]
        err = (maps[:n].cpu() - ref).abs().max().item()
        if dtype == "float32":
            tol, what = GOLDEN_TOL, f"tol {GOLDEN_TOL:g}"
        else:
            yard = (ref - cpu["float32"][0][:n]).abs().max().item()
            tol, what = BF16_FACTOR * yard, f"{BF16_FACTOR:g} x the CPU's bf16-vs-fp32 {yard:.3e}"
        print(f"  DPM-Solver++(2M) {dtype}, w=2, {DPM_STEPS} steps: {BATCH} maps in "
              f"{seconds:.3f} s ({BATCH / seconds * 60:.1f} maps/min on this card, "
              f"{seconds / DPM_STEPS * 1e3:.3f} ms a step); first {n} vs the CPU "
              f"({cpu_seconds:.3f} s): max abs {err:.3e} ({what}); P(k) vs exact chain, "
              f"N={BATCH} (information only): {pk_deviation(pk.cpu().numpy(), 2)}", flush=True)
        if not err <= tol:
            raise SystemExit(f"DPM-Solver++(2M) {dtype} on the card vs the CPU: {err} > {tol}")


def check_profile(dev, drive) -> None:
    """Phase (q4): ``run_experiment("nov26")`` of two epochs at
    ``PROFILE_T`` on ``PROFILE_MAPS`` maps with ``CAMELS_PROFILE`` set: one Chrome trace, of the
    second epoch, holding CUDA kernel events."""
    trace_dir = os.path.join(OUT_DIR, "profile")
    shutil.rmtree(trace_dir, ignore_errors=True)
    cfg = ExperimentConfig(mode="nov26", lrate=1e-4, n_epoch=2, timesteps=PROFILE_T,
                           n_eval_images=4, max_maps=PROFILE_MAPS,
                           output_root=os.path.join(OUT_DIR, "exp_profile"))
    shutil.rmtree(cfg.output_root, ignore_errors=True)
    n_maps = min(cfg.synthetic_param_sets, max(1, PROFILE_MAPS // 15)) * 15
    n_train = n_maps - min(cfg.test_size, max(n_maps // 10, 1))
    os.environ["CAMELS_PROFILE"] = trace_dir
    try:
        drive("run_experiment_profiled", lambda: experiment.run_experiment(cfg, device=dev),
              steps=PROFILE_T * sampler_calls(cfg),
              train_forwards=2 * num_batches(n_train, cfg.batch_size))
    finally:
        del os.environ["CAMELS_PROFILE"]
    names = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    if len(names) != 1:
        raise SystemExit(f"CAMELS_PROFILE: expected one trace in {trace_dir}, found {names}")
    path = os.path.join(trace_dir, names[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    print(f"  CAMELS_PROFILE: {names[0]}, {os.path.getsize(path)} bytes, {len(events)} events, "
          f"{len(kernels)} CUDA kernels ({busy:.3f} ms of kernel time)")
    if not kernels:
        raise SystemExit("CAMELS_PROFILE: the trace holds no CUDA kernel")


def shard_cases(model, randn, c_eps, inv_sqrt_a, sigma) -> list:
    """Phase (r1)'s cases, fp32 and bf16: K2's statistics and apply
    launches on one half of the w=2 serving heads' maps (summed: one
    spatial decoder call of a 1x2 mesh's rank), of the deep model's
    out_norm at 10 maps and of n_feat 136's and 264's heads (17, 33 and 66
    channels a group: lanes past a CTA's last whole pixel idle), the
    partials of both halves merged; K3 on half of FiLM stage 1's map; K1's
    halo mode on half of the w=2 serving features (summed: one spatial
    reverse step), its rows above and below from the other half's edge,
    the bf16 kernel's narrow item in its halo mode at n_feat 32's half and
    with a masked last block at n_feat 40's and 264's, and the split
    launch's halo mode at the widths the kernels of their own do not take
    (6000 channels in either type, no model's)."""
    cases = []
    n = 2 * BATCH
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        for label, batch, hw, c, act, norm, film, summed in (
                ("up0_norm (apply: with the FiLM epilogue), half of (32,16,16,256)", n, (8, 16),
                 256, "relu", model.up0_norm, True, True),
                ("out_norm, half of (32,64,64,128)", n, (32, 64), 128, "relu", model.out_norm,
                 False, True),
                ("deep out_norm, half of (10,128,128,128)", VARIANT_BATCH, (64, 128), 128,
                 "leaky_relu", None, False, False),
                ("n_feat 136 out_norm, half of (32,64,64,136)", n, (32, 64), 136, "relu", None,
                 False, False),
                ("n_feat 264 out_norm, half of (32,64,64,264)", n, (32, 64), 264, "relu", None,
                 False, False),
                ("n_feat 264 up0_norm (apply: with the FiLM epilogue), half of (32,16,16,528)",
                 n, (8, 16), 528, "relu", None, True, False),
                ("n_feat 1032 up0_norm (apply: with the FiLM epilogue), the pair's launches "
                 "on (32,16,16,2064)", n, (16, 16), 2064, "relu", None, True, False)):
            gamma, beta = ((norm.weight.detach(), norm.bias.detach()) if norm is not None
                           else (randn(c), randn(c)))
            halves = [randn(batch, *hw, c).to(dtype) for _ in range(2)]
            x = halves[0]
            parts = torch.stack([groupnorm_stats_plain(hf, 8) for hf in halves])
            rows = (randn(batch, c).to(dtype), randn(1, c).to(dtype)) if film else None
            stats_args = (x, 8)
            cases.append((
                f"groupnorm_stats{sfx}", f"{label} {tuple(x.shape)}", groupnorm_stats,
                groupnorm_stats_plain,
                lambda x, g: torch.var_mean(x.reshape(x.shape[0], -1, g, x.shape[-1] // g).float(),
                                            dim=(1, 3), correction=0),
                stats_args, nbytes(x) + 4 * 3 * batch * 8, x.numel() * 3, summed))
            apply_args = (x, parts, gamma, beta, 8, 1e-5, act, rows)
            cases.append((
                f"groupnorm_apply{sfx}", f"{label} {tuple(x.shape)}", groupnorm_apply,
                groupnorm_apply_plain, None, apply_args, nbytes(*apply_args, x),
                x.numel() * (12 if rows else 10), summed))
        args = (randn(n, 16, 32, 128).to(dtype), randn(n, 128).to(dtype),
                randn(1, 128).to(dtype))
        cases.append((
            f"film{sfx}", f"stage 1, half of (32,32,32,128) {tuple(args[0].shape)}", fused_film,
            film_plain,
            lambda x, scale, shift: torch.addcmul(
                shift[:, None, None, :], x, scale[:, None, None, :]),
            args, nbytes(*args, args[0]), args[0].numel() * 2, False))
        halo_cases = [(f"head_step_halo{sfx}", BATCH, 32, 64, model.n_feat,
                       "cfg w=2, half of h(32,64,64,128)")]
        halo_cases += ([(f"head_step_halo_narrow{sfx}", BATCH, 32, 64, NARROW_FEAT,
                         f"cfg w=2, n_feat {NARROW_FEAT} (a narrow model), half of "
                         f"h(32,64,64,{NARROW_FEAT})")]
                       + [(f"head_step_halo_masked{sfx}", BATCH, 32, 64, c,
                           f"cfg w=2, n_feat {c} (a masked last block), half of "
                           f"h(32,64,64,{c})") for c in (40, WIDE_FEAT)] if sfx else [])
        halo_cases.append((f"head_step_halo_split{sfx}", 1, 4, 8, 6000,
                           "cfg w=2, 6000 channels (no model's: weights over the halo "
                           "kernels' shared memory), half of h(2,8,8,6000)"))
        seen = set()
        for b, height, width, c, cout in COUT_HALO:
            args = head_args(randn, dtype, b, height, width, c, cout, halo=True)
            name = f"head_step_halo_{cout_kind(b, height, width, c, dtype, cout, True)}{sfx}"
            cases.append((
                name, f"{cout} image channels, cfg w=2, half of h{(2 * b, 2 * height, width, c)} "
                f"x{tuple(args[3].shape)}, halo rows (2, {2 * b}, {width}, {c})",
                fused_head_step, head_step_plain,
                lambda h, weight, bias, *_: F.conv2d(h.permute(0, 3, 1, 2), weight, bias,
                                                     padding=1),
                args, nbytes(*args, args[3]), args[0].numel() * 18 * cout + args[3].numel() * 8,
                name not in seen))
            seen.add(name)
        for name, b, height, width, c, label in halo_cases:
            h = randn(2 * b, height, width, c).relu().to(dtype)
            halo = tuple(randn(2 * b, width, c).relu().to(dtype) for _ in range(2))
            x, z = randn(b, height, width, 1), randn(b, height, width, 1)
            head = ((model.out_conv2.weight.detach().to(dtype),
                     model.out_conv2.bias.detach().to(dtype)) if c == model.n_feat else
                    (randn(1, c, 3, 3).mul(1 / (3 * c**0.5)).to(dtype), randn(1).to(dtype)))
            args = (h, *head, x, z, c_eps, inv_sqrt_a, sigma, 2.0, False, halo)
            cases.append((
                name, f"{label} h{tuple(h.shape)} x{tuple(x.shape)}, halo rows "
                f"(2, {2 * b}, {width}, {c})", fused_head_step, head_step_plain,
                lambda h, weight, bias, *_: F.conv2d(h.permute(0, 3, 1, 2), weight, bias,
                                                     padding=1),
                args, nbytes(*args, x), h.numel() * 18 + x.numel() * 8, True))
    return cases


def merge_cases(stats: dict, more: dict) -> None:
    """Phase (r1)'s :func:`hold_cases` results into phase (c)'s: a kernel
    both phases hold (K3 on a shard, for information) keeps phase (c)'s
    summed times and gains the cases and the worst error."""
    for name, r in more.items():
        if name not in stats:
            stats[name] = r
            continue
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], r["max_abs_err"])
        stats[name]["shapes"] += r["shapes"]


def check_shard_kernels(dev, model) -> dict:
    """Phase (r1): :func:`shard_cases` held by :func:`hold_cases`."""
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    c_eps, inv_sqrt_a, sigma = ddpm_coefficients(
        make_schedule(TIMESTEPS), torch.tensor([750]))[0].tolist()
    return hold_cases(shard_cases(model, randn, c_eps, inv_sqrt_a, sigma))


def count_collectives():
    """A context that counts ``torch.distributed.all_reduce`` calls and
    ``broadcast`` calls in ``counts[0]``."""
    counts = [0]
    dist = torch.distributed
    calls = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}

    def counting(fn):
        def call(*args, **kwargs):
            counts[0] += 1
            return fn(*args, **kwargs)
        return call

    @contextlib.contextmanager
    def ctx():
        for name, fn in calls.items():
            setattr(dist, name, counting(fn))
        try:
            yield counts
        finally:
            for name, fn in calls.items():
                setattr(dist, name, fn)

    return ctx()


def spatial_chain(model, dev, mesh=None) -> torch.Tensor:
    """Phase (r2): ``sample_ddpm`` at w=2 on ``SPATIAL_MAPS`` maps over the
    exact chain of a ``SPATIAL_T``-step schedule, its draws from a seeded
    generator on ``dev``; with ``mesh`` (2-D) ``spatial=True``."""
    return sample_ddpm(model, make_schedule(SPATIAL_T), torch.Generator(device=dev).manual_seed(7),
                       n_sample=SPATIAL_MAPS, params=certification_contexts(SPATIAL_MAPS),
                       guide_w=2.0, device=dev, mesh=mesh, spatial=mesh is not None)


def deep_folded(dev) -> ContextUnet:
    """Phase (r2): the deep model at full width from its seeded init
    (:func:`variant_model`), BatchNorms folded, on ``dev``."""
    return load_model(to_jax_variables(variant_model("deep").state_dict()), dev)


def deep_forward(model, dev, mesh=None) -> torch.Tensor:
    """Phase (r2): the folded deep model's eps on ``VARIANT_CHECK_BATCH``
    maps of :func:`variant_batch` at t/T 0.5, in one process or on this
    rank's height shard, gathered."""
    x, c, _, _, _ = variant_batch(model, VARIANT_CHECK_BATCH, seed=8)
    t = np.full(VARIANT_CHECK_BATCH, 0.5, np.float32)
    with torch.no_grad():
        if mesh is None:
            return model(torch.tensor(x, device=dev), torch.tensor(t, device=dev),
                         torch.tensor(c, device=dev))
        xs, ts, cs = shard_batch_spatial(mesh, x, t, c)
        return gather_blocks(mesh, model(xs, ts, cs, space=mesh.space), VARIANT_CHECK_BATCH)


def read_launches() -> dict:
    return {name: getattr(w, count) for name, (w, count) in WRAPPERS.items()}


def zero_launches() -> None:
    for wrapper, count in WRAPPERS.values():
        setattr(wrapper, count, 0)


def spatial_rank(world, model_path: str, batch, spawned: float) -> dict:
    """Phase (r2), in each of two ranks sharing the card as a (1 x 2)
    mesh: one train step of ``batch`` (rank 0's gradients in full, the
    other's as a digest) and the ms and collectives of a step; the spatial
    chain with its launch counts, then again timed; the deep model's folded
    forward with its launch counts; the seconds of each part, the
    start-up's from ``spawned``."""
    seconds, t1 = {"start-up": time.time() - spawned}, time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # a new process: the forward is called directly
    torch.backends.cuda.matmul.allow_tf32 = False

    def lap(part):
        nonlocal t1
        torch.cuda.synchronize(world.device)
        seconds[part], t1 = time.perf_counter() - t1, time.perf_counter()

    mesh = make_mesh_2d(*SPATIAL_MESH, device=world.device)
    dev = mesh.device
    variables = load_variables(model_path)
    lap("load")
    step = mesh_step(variables, dev, batch, mesh)
    step["digest"] = grads_digest(step["grads"])
    if mesh.rank:
        del step["grads"]
    lap("gated step")
    with count_collectives() as step_calls:
        step_ms = time_mesh_steps(variables, dev, batch, mesh, warm=1, timed=2)
    lap("timed step")
    model = load_model(variables, dev)
    zero_launches()
    maps = spatial_chain(model, dev, mesh).cpu()
    torch.cuda.synchronize(dev)
    chain_launches = read_launches()
    lap("chain")
    with count_collectives() as chain_calls:
        spatial_chain(model, dev, mesh)
        torch.cuda.synchronize(dev)
    chain_ms = (time.perf_counter() - t1) / SPATIAL_T * 1e3
    lap("timed chain")
    model_bf16 = load_model(variables, dev, dtype=torch.bfloat16)
    zero_launches()
    maps_bf16 = spatial_chain(model_bf16, dev, mesh).cpu()
    torch.cuda.synchronize(dev)
    bf16_launches = read_launches()
    lap("bf16 chain")
    deep = deep_folded(dev)
    zero_launches()
    eps = deep_forward(deep, dev, mesh).cpu()
    torch.cuda.synchronize(dev)
    deep_launches = read_launches()
    lap("deep forward")
    return {"step": step, "step_ms": step_ms, "step_collectives": step_calls[0] / 3,
            "maps": maps, "chain_ms": chain_ms, "chain_collectives": chain_calls[0] / SPATIAL_T,
            "chain_launches": chain_launches, "maps_bf16": maps_bf16,
            "bf16_launches": bf16_launches, "deep_eps": eps, "deep_launches": deep_launches,
            "seconds": seconds}


def check_spatial(dev, model, variables, model_path: str, q2: dict, launches: dict) -> None:
    """Phase (r2) (module docstring): the ranks start while this process
    takes the one-process chains (fp32 and bf16) and the deep model's
    forward; the train step is held against (q2)'s one-process step and
    witness of the same batch; the bf16 chain within ``BF16_FACTOR`` x one
    process's bf16-vs-fp32 distance of one process's bf16 chain."""
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(spawn, spatial_rank, SPATIAL_MESH[0] * SPATIAL_MESH[1],
                              (model_path, q2["batch"], time.time()),
                              store_dir=tempfile.mkdtemp(dir=OUT_DIR), backend="gloo",
                              device=dev, timeout=MESH_TIMEOUT)
        want_maps = spatial_chain(model, dev).cpu()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        spatial_chain(model, dev)
        torch.cuda.synchronize(dev)
        one_chain_ms = (time.perf_counter() - t2) / SPATIAL_T * 1e3
        want_bf16 = spatial_chain(load_model(variables, dev, dtype=torch.bfloat16), dev).cpu()
        deep = deep_folded(dev)
        want_eps = deep_forward(deep, dev).cpu()
        del deep
        ranks = pending.result()
    print(f"  (1 x 2) mesh of two gloo ranks on {dev}: {time.perf_counter() - t1:.3f} s, "
          f"start-up included (rank 0: "
          f"{', '.join(f'{k} {v:.3f}' for k, v in ranks[0]['seconds'].items())} s)", flush=True)
    if ranks[1]["step"]["digest"] != ranks[0]["step"]["digest"]:
        raise SystemExit("spatial train step: the ranks' gradients differ")
    hold_mesh_step("spatial train step, batch 32 on a (1 x 2) mesh", ranks[0]["step"],
                   q2["want"], q2["witness"])
    want_chain = {name: 0 for name in WRAPPERS}
    want_chain.update({k: v * SPATIAL_T for k, v in SPATIAL_PER_STEP.items()})
    want_bf16_launches = {name: 0 for name in WRAPPERS}
    want_bf16_launches.update({instance(k, "bfloat16"): v * SPATIAL_T
                               for k, v in SPATIAL_PER_STEP.items()})
    yard = (want_bf16 - want_maps).abs().max().item()
    want_deep = {name: 0 for name in WRAPPERS}
    want_deep.update(SPATIAL_PER_FORWARD)
    for r, rank in enumerate(ranks):
        err = (rank["maps"] - want_maps).abs().max().item()
        deep_err = (rank["deep_eps"] - want_eps).abs().max().item()
        launches[f"spatial_ddpm_w2_rank{r}"] = rank["chain_launches"]
        launches[f"spatial_deep_forward_rank{r}"] = rank["deep_launches"]
        launches[f"spatial_ddpm_w2_bf16_rank{r}"] = rank["bf16_launches"]
        err16 = (rank["maps_bf16"] - want_bf16).abs().max().item()
        print(f"  rank {r}: sample_ddpm(spatial=True) w=2, {SPATIAL_MAPS} maps, T "
              f"{SPATIAL_T}: max abs vs one process {err:.3e} (tol {SPATIAL_TOL:g}), "
              f"{rank['chain_ms']:.3f} ms a step (one process {one_chain_ms:.3f}), "
              f"{rank['chain_collectives']:g} collectives a step; launches "
              f"{rank['chain_launches']}; train step {rank['step_ms']:.3f} ms, "
              f"{rank['step_collectives']:g} collectives; deep folded forward (2 maps, 128x128) "
              f"max abs vs one process {deep_err:.3e} (tol {SPATIAL_TOL:g}); launches "
              f"{rank['deep_launches']}", flush=True)
        print(f"  rank {r}: the same chain in bf16: max abs vs one process's bf16 chain "
              f"{err16:.3e} ({BF16_FACTOR:g} x one process's bf16-vs-fp32 {yard:.3e}); "
              f"launches {rank['bf16_launches']}", flush=True)
        if not (err <= SPATIAL_TOL and deep_err <= SPATIAL_TOL and err16 <= BF16_FACTOR * yard):
            raise SystemExit(f"rank {r}: spatial chain {err}, deep forward {deep_err}, "
                             f"bf16 chain {err16} (yardstick {yard})")
        for path, got, want in (("chain", rank["chain_launches"], want_chain),
                                ("bf16 chain", rank["bf16_launches"], want_bf16_launches),
                                ("deep forward", rank["deep_launches"], want_deep)):
            if got != want:
                raise SystemExit(f"rank {r}: launches on the spatial {path}: {got}, "
                                 f"expected {want}")


def check_quantconv(dev, variables) -> None:
    """Phase (r3): ``QuantConv`` holding the folded checkpoint's
    ``down2.block2.conv2`` on ``QUANT_BATCH`` ReLU'd maps of 256 channels
    at 32x32, on the card against the CPU bit for bit, timed beside
    cuDNN's fp32 and bf16 conv of the same shape (information only)."""
    params = fold_batchnorm_variables(variables)["params"]["down2"]["block2"]["conv2"]["conv"]
    cin, cout = params["kernel"].shape[2:]
    conv = QuantConv(cin, cout).load_jax_params(params)
    x = torch.randn((QUANT_BATCH, cin, 32, 32), generator=torch.Generator().manual_seed(9)).relu()
    with torch.no_grad():
        want = conv(x)
        conv_card = copy.deepcopy(conv).to(dev)
        x_card = x.to(dev)
        got = conv_card(x_card).cpu()
        same = torch.equal(got, want)
        diff = (got - want).abs().max().item()
        # The card's int32 sums against the exact ones (float64 on the card).
        x_q, _ = quantize_symmetric(x_card)
        w_q, _ = quantize_symmetric(conv_card.weight, axis=(1, 2, 3))
        exact = F.conv2d(x_q.double(), w_q.double(), padding=1)
        sums_exact = torch.equal(int8_conv_sums(x_q, w_q).double(), exact)
        w, b = conv_card.weight, conv_card.bias
        ms = time_ms(conv_card, (x_card,))
        fp32_ms = time_ms(lambda x: F.conv2d(x, w, b, padding=1), (x_card,))
        bf16_ms = time_ms(lambda x: F.conv2d(x, w.bfloat16(), b.bfloat16(), padding=1),
                          (x_card.bfloat16(),))
    print(f"  QuantConv W8A8 (down2.block2.conv2, {cin} -> {cout}, x{tuple(x.shape)}): card vs "
          f"CPU {'bit for bit' if same else 'DIFFERENT'} (max abs {diff:.3e}), the card's int32 "
          f"sums {'exact' if sums_exact else 'NOT exact'}; "
          f"{ms:.5f} ms against cuDNN fp32 {fp32_ms:.5f} ms and bf16 {bf16_ms:.5f} ms "
          "(information only)", flush=True)
    if not (same and sums_exact):
        raise SystemExit(f"QuantConv on the card vs the CPU: max abs {diff}, int32 sums "
                         f"exact: {sums_exact}")


def make_drive(launches: dict):
    """``drive``, which runs one main path and records its launch counts
    in ``launches[path]``."""

    def drive(path, fn, steps=0, forwards=0, train_forwards=0, dtype="float32", extra=None,
              kinds=None):
        """Run one main path with every launch count at 0 and read the
        counts: a sampler path of ``steps`` reverse steps must show
        ``LAUNCHES_PER_STEP`` a step and no conv to the image channels (the
        step kernel applies ``out_conv2``); a likelihood path of
        ``forwards`` model calls ``LAUNCHES_PER_FORWARD`` a call and one
        such conv each; ``train_forwards`` training forwards no launch and
        one such conv each.  ``forwards=None``: as many likelihood forwards
        as convs to the image channels beyond the training forwards (a
        run's many passes).
        The launches are those of the ``dtype`` instances; the other
        instances must show none, but for ``extra`` (instance -> launches:
        the narrow bf16 kernels of a narrow bf16 model) and ``kinds``
        (instance -> (launches a step, launches a forward): the fp32
        designs of the variants' heads, :func:`variant_kinds`)."""
        one_channel_convs = [0]  # convs to the image channels (out_conv2)

        def hook(module, args, output):  # the card's only: q3 runs CPU forwards beside q1
            if isinstance(module, OutputConv2d) and output.is_cuda:
                one_channel_convs[0] += 1

        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        for wrapper, count in WRAPPERS.values():
            setattr(wrapper, count, 0)
        try:
            result = fn()
            torch.cuda.synchronize()
        finally:
            handle.remove()
        launches[path] = {name: getattr(w, count) for name, (w, count) in WRAPPERS.items()}
        print(f"  launches on {path}: {launches[path]}; convs to the image channels: "
              f"{one_channel_convs[0]}", flush=True)
        if forwards is None:
            forwards = one_channel_convs[0] - train_forwards
        if forwards < 0 or one_channel_convs[0] != forwards + train_forwards:
            raise SystemExit(f"{one_channel_convs[0]} convs to the image channels on {path}, "
                             f"expected {forwards + train_forwards}")
        want = {name: 0 for name in WRAPPERS}
        for name in LAUNCHES_PER_STEP:
            want[instance(name, dtype)] = (steps * LAUNCHES_PER_STEP[name]
                                           + forwards * LAUNCHES_PER_FORWARD[name])
        want.update(extra or {})
        want.update({name: steps * a + forwards * b for name, (a, b) in (kinds or {}).items()})
        if any(want[name] and not launches[path][name] for name in WRAPPERS):
            raise SystemExit(f"a kernel never launched on {path}: {launches[path]}")
        if launches[path] != want:
            raise SystemExit(f"launches on {path}: {launches[path]}, expected {want}")
        return result

    return drive


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    phase("(a) build kernels", t0)
    print(f"  {lib}")
    for line in _build.build_seconds(lib):
        print(f"  nvcc {line} s")
    for line in _build.ptxas_report(lib, PTXAS_KERNELS):
        print(f"  ptxas {line}")

    t0 = time.perf_counter()
    cfg2 = resolve_serving_config(2)  # md5 of the checkpoint vs every stamp
    variables = load_variables(cfg2.model_path)
    model = load_model(variables, dev)
    phase("(b) load checkpoint", t0)
    print(f"  {cfg2.model_path} md5 {cfg2.checkpoint_fingerprint}")

    t0 = time.perf_counter()
    stats = check_kernels(dev, model)
    phase("(c) kernels vs plain", t0)

    t0 = time.perf_counter()
    check_golden(dev, model)
    models = (model, load_model(variables, "cpu"))  # the card's and the CPU's
    check_sampler_vs_cpu(models, [1, 4, 7, 10], "beta", "strided w=2")
    phase("(d) golden forward, sampler vs CPU", t0)

    launches = {}  # path -> kernel -> launches on that path
    drive = make_drive(launches)

    t0 = time.perf_counter()
    served = {}
    for w, steps in ((2, 500), (0, 430)):
        r = drive(f"serve_w{w}",
                  lambda w=w: serve(w, BATCH, OUT_DIR, seed=0, device=dev,
                                    params=certification_contexts(BATCH)), steps=steps)
        check_maps(r["maps"], BATCH, f"serve w={w}")
        if r["steps"] != steps or not np.isfinite(r["pk"]).all():
            raise SystemExit(f"serve w={w}: {r['steps']} steps or non-finite P(k)")
        served[w] = r
        print(f"  serve w={w}: {r['config']}, {BATCH} maps in {r['seconds']:.3f} s "
              f"({BATCH / r['seconds'] * 60:.1f} maps/min on this card); "
              f"P(k) vs exact chain, N={BATCH} (information only): "
              f"{pk_deviation(r['pk'], w)}", flush=True)
    phase("(e) certified serving", t0)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    t1 = time.perf_counter()
    maps = drive("ddpm_exact", lambda: sample_ddpm(
        model, make_schedule(TIMESTEPS), gen, n_sample=4,
        params=certification_contexts(4), guide_w=0.0, device=dev), steps=TIMESTEPS)
    seconds = time.perf_counter() - t1
    check_maps(maps, 4, "exact DDPM")
    _, pk = power_spectrum_batch(maps[..., 0])
    print(f"  exact DDPM w=0: 4 maps, {TIMESTEPS} steps in {seconds:.3f} s; "
          f"P(k) vs exact chain, N=4 (information only): "
          f"{pk_deviation(pk.cpu().numpy(), 0)}")
    phase("(f) exact DDPM", t0)

    t0 = time.perf_counter()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "camels_diffusion_model_tpu"))
    if foreign:
        raise SystemExit(f"the port imported {foreign[:5]}")
    phase("(g) imports", t0)

    t0 = time.perf_counter()
    schedule = make_schedule(TIMESTEPS)
    for w in (2, 0):
        maps_np = served[w]["maps"].cpu().numpy()
        ref = np.load(os.path.join(REFS, f"w{w}", "DDPM_1500_seed_A.npz"))
        pdf = PooledPdf().add(maps_np).pdf
        t1 = time.perf_counter()
        elbo, bpd = drive(f"battery_w{w}", lambda: calculate_elbo_and_bpd(
            model, schedule, [(maps_np, served[w]["params"])],
            torch.Generator(device=dev).manual_seed(ELBO_SEED), device=dev),
            forwards=10)
        print(f"  battery w={w}, N={BATCH} served maps (information only): pixel PDF "
              f"TV to the exact chain {pdf_tv(pdf, ref['pdf']):.5f}; ELBO {elbo:.6g} "
              f"BPD {bpd:.6g} (reference, N=16384, bf16 on a TPU: ELBO "
              f"{float(ref['elbo']):.6g} BPD {float(ref['bpd']):.6g}); ELBO in "
              f"{time.perf_counter() - t1:.3f} s", flush=True)
    check_likelihood_vs_cpu(
        models, lambda m, x, c, nf: elbo_bpd_batch(m, schedule, x, c, noise_fn=nf,
                                                   device=on(m)),
        served[2]["maps"][:2].cpu().numpy(), served[2]["params"][:2], 10,
        "ELBO of 2 served w=2 maps")
    phase("(h) battery on served maps", t0)

    t0 = time.perf_counter()
    c4 = certification_contexts(4)
    t1 = time.perf_counter()
    nll = drive("nll_sweep", lambda: nll_batch(
        model, schedule, maps, c4, torch.Generator(device=dev).manual_seed(1),
        device=dev), forwards=TIMESTEPS)
    seconds = time.perf_counter() - t1
    if tuple(nll.shape) != (4,) or not bool(torch.isfinite(nll).all()):
        raise SystemExit(f"NLL sweep: {nll}")
    print(f"  NLL sweep, {TIMESTEPS} timesteps at batch 4 in {seconds:.3f} s "
          f"({seconds / TIMESTEPS * 1e3:.3f} ms a timestep): {nll.tolist()}")
    x2, c2 = maps[:2].cpu().numpy(), c4[:2]
    if not check_likelihood_vs_cpu(
            models, lambda m, x, c, nf: nll_batch(m, schedule, x, c, ts=range(1, 9),
                                                  noise_fn=nf, device=on(m)),
            x2, c2, 8, "NLL over t = 1..8", fail=False):
        for t in range(1, 9):  # 1/(2 b_1) = 4.4e3 weighs t = 1 most: each term
            check_likelihood_vs_cpu(
                models, lambda m, x, c, nf, t=t: nll_batch(
                    m, schedule, x, c, ts=[t], noise_fn=nf, device=on(m)),
                x2, c2, 1, f"NLL term t={t}", fail=False)
        raise SystemExit(f"NLL over t = 1..8 on the card vs the CPU: beyond "
                         f"rel {LIKELIHOOD_REL}")
    phase("(i) NLL sweep", t0)

    t0 = time.perf_counter()
    taus = ddim_timesteps(TIMESTEPS, 50)
    t1 = time.perf_counter()
    ddim_maps = drive("ddim_posterior_w2", lambda: sample_ddim(
        model, schedule, torch.Generator(device=dev).manual_seed(2), n_sample=BATCH,
        params=certification_contexts(BATCH), guide_w=2.0, n_steps=50, eta=0.0,
        sigma_mode="posterior", device=dev), steps=len(taus))
    seconds = time.perf_counter() - t1
    check_maps(ddim_maps, BATCH, "posterior DDIM")
    print(f"  posterior DDIM w=2, eta 0: {BATCH} maps, {len(taus)} steps in "
          f"{seconds:.3f} s ({seconds / len(taus) * 1e3:.3f} ms a step)")
    check_sampler_vs_cpu(models, taus[:4], "posterior", "posterior DDIM w=2")
    phase("(j) posterior DDIM", t0)

    t0 = time.perf_counter()
    t1 = time.perf_counter()
    recon = drive("reconstruct", lambda: reconstruct(
        model, schedule, served[2]["maps"][:4], c4,
        torch.Generator(device=dev).manual_seed(3), save_rate=20, device=dev),
        steps=TIMESTEPS)
    seconds = time.perf_counter() - t1
    check_maps(recon.x, 4, "reconstruction")
    n_saves = save_schedule(TIMESTEPS, 20)[2]
    if (tuple(recon.intermediate.shape) != (n_saves, 4, 64, 64, 1)
            or not bool(torch.isfinite(recon.intermediate).all())):
        raise SystemExit(f"reconstruction: intermediates {tuple(recon.intermediate.shape)}, "
                         f"expected {n_saves} finite states")
    print(f"  reconstruction: 4 maps from t = {TIMESTEPS} in {seconds:.3f} s, "
          f"{n_saves} saved states")
    phase("(k) reconstruction", t0)

    t0 = time.perf_counter()
    train_ref = check_train_step(lambda device: training_model(variables, device), dev,
                                 train_batch())
    model_l, state_l, step_l, batch_l, losses = drive(
        "train_steps", lambda: fixed_objective(dev), train_forwards=FIXED_STEPS)
    print(f"  fixed objective, {FIXED_STEPS} Adam steps at lr 1e-3 from a fresh init: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} (ratio {losses[-1] / losses[0]:.4f})")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall on a fixed batch: {losses}")
    print_train_time("", time_train_steps(dev, state_l, step_l, batch_l))
    del model_l, state_l, step_l, batch_l
    phase("(l1) train step vs CPU, guard, fixed objective, step time", t0)

    t0 = time.perf_counter()
    nov26_state = check_nov26(dev, drive, "float32")
    phase("(l2) run_experiment and resume", t0)

    t0 = time.perf_counter()
    for name in ("deep", "big"):
        t1 = time.perf_counter()
        check_variant(name, dev, drive)
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t1:.3f} s", flush=True)
    phase("(m) the deep and big models at full width", t0)

    t0 = time.perf_counter()
    check_runs(dev, drive)
    phase("(n) run_experiment initial, main, paper", t0)

    t0 = time.perf_counter()
    check_bf16(dev, drive, variables, models[1], served, train_ref)
    phase("(o) bf16 at full width", t0)

    t0 = time.perf_counter()
    check_reference_workflow(dev, drive, variables)
    phase("(p) the reference workflow at full width", t0)

    t0 = time.perf_counter()
    params, x_init = dpm_inputs(dev)
    q2 = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # q3's CPU side beside q1
        dpm_cpu = pool.submit(dpm_on_cpu, variables, models[1], params, x_init.cpu())
        for name, run in (
                ("(q1) mesh of one process, NCCL", lambda: check_mesh_one(dev, drive,
                                                                          nov26_state)),
                ("(q2) two gloo ranks on the card", lambda: q2.update(check_mesh_two(
                    dev, variables, model, cfg2.model_path, launches))),
                ("(q3) DPM-Solver++(2M)", lambda: check_dpm(
                    dev, drive, variables, model, params, x_init, dpm_cpu.result())),
                ("(q4) CAMELS_PROFILE", lambda: check_profile(dev, drive))):
            t1 = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            phase(name, t1)
    phase("(q) data parallelism, DPM-Solver++(2M), CAMELS_PROFILE", t0)

    t0 = time.perf_counter()
    for name, run in (
            ("(r1) sharded kernel modes vs plain", lambda: merge_cases(
                stats, check_shard_kernels(dev, model))),
            ("(r2) a (1 x 2) spatial mesh of two gloo ranks", lambda: check_spatial(
                dev, model, variables, cfg2.model_path, q2, launches)),
            ("(r3) QuantConv", lambda: check_quantconv(dev, variables))):
        t1 = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        phase(name, t1)
    phase("(r) the spatial mesh, QuantConv", t0)

    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        check_pair_model(dev, drive, dtype)
        torch.cuda.empty_cache()
    phase(f"(s) n_feat {PAIR_FEAT}: K2's statistics and apply launches on one card", t0)

    t0 = time.perf_counter()
    for in_channels, paths in CHANNELS:
        for dtype in ("float32", "bfloat16"):
            check_channels_model(dev, drive, dtype, in_channels, paths)
            torch.cuda.empty_cache()
    phase(f"(t) models of {' and '.join(str(k) for k, _ in CHANNELS)} image channels", t0)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "camels_diffusion_model_tpu"))
    if foreign:
        raise SystemExit(f"the port imported {foreign[:5]}")
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": sum(counts[name] for counts in launches.values()),
        "launches_by_path": {path: counts[name] for path, counts in launches.items()},
        "library_call": LIBRARY[name],
        **{k: stats[name][k] for k in ("max_abs_err", "ms", "warm_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms", "shapes")},
    } for name in WRAPPERS]
    print(f"total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
