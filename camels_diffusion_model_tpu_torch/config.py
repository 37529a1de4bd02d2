"""Experiment configuration and mode registry: a copy of
``camels_diffusion_model_tpu/config.py`` (which imports no JAX, but this
package imports nothing of that one).

One runner, ``cli.experiment.run_experiment``, is parameterised by a
:class:`ModeSpec` per reference script: its positional CLI, its
``outputs/<prefix>...`` directory, its artifact names and its log lines.
The reference's module constants (beta1/beta2, n_feat, batch size, test
size, eval and checkpoint cadences, data paths) are fields of
:class:`ExperimentConfig`.  ``mesh_devices`` is the data-parallel process
count: ``run_experiment`` takes a mesh of that many processes (one a card,
launched by torchrun), which must be the initialised group's size, and
raises otherwise; None takes the group's size.  Every mode, the deep and
big variants' included, runs in ``dtype`` "float32" or "bfloat16", with
``shortcut`` "learned" or "stochastic".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """What a given train_diffusion_* variant computes and emits."""

    name: str
    prefix: str  # output-dir prefix, formatted with config fields
    conditional: bool = True
    timing_log: bool = True  # writes timing_and_performance.log
    track_val_mse: bool = True  # val MSE every eval_every epochs
    eval_elbo: bool = False  # dataset ELBO/BPD at eval points (paper form)
    eval_nll: bool = False  # NLL on 200-sample subsets at eval points
    per_batch_elbo: bool = False  # ELBO/BPD accumulated per training batch
    post_metrics: bool = False  # ELBO/BPD/NLL on recon/grid/guidance samples
    styled_plots: bool = True  # paper.py styling vs plain variants
    viridis: bool = False  # viridis visualization artifacts
    recon_power_spectra: bool = False  # compare_power_spectra on reconstructions
    mean_correction: bool = False  # unconditional mean-ratio correction pass
    param_index_mode: bool = False  # 4th CLI arg selects ONE parameter column
    param_grid: bool = True  # post-training parameter grid sweep
    guidance_sweep: bool = True  # CFG strength sweep
    sensitivity: bool = True  # per-parameter sensitivity rows
    training_metrics_figure: bool = False  # 4-panel training_metrics.png
    plot_style: str = "default"  # figure font style ("paper1": large fonts)
    val_nll_only: bool = False  # spectrum_final: NLL on the test split only
    # Checkpoint contract (differs per reference script):
    #   "plus1":  save when (ep+1) % every == 0 or last; name model_epoch_{ep+1}
    #             (code/ conditional scripts, e.g. paper.py:476-478)
    #   "list25": save when (ep+1) in {25,50,75,100}; name model_epoch_{ep} — note
    #             the reference's own off-by-one (train_diffusion.py:154-155),
    #             and NO forced last-epoch save
    #   "mod0":   save when ep % every == 0 or last; name model_epoch_{ep}
    #             (initial.py:175-176, initial2/main/26thNovCode)
    ckpt_every: int = 25
    ckpt_style: str = "plus1"
    # Model/data selection (legacy root-level variants):
    model_variant: str = "canonical"  # "canonical" | "deep" | "big"
    data_style: str = "code"  # normalization recipe (data.pipeline)
    q_scaling: str = "reference"  # training q_sample scaling (NoiseScaling)
    def_height: int = 64
    def_n_feat: int = 128
    def_n_cfeat: int = 0  # 0 -> num_params (conditional) / 5 (uncond default)
    pure_noise_sampling: bool = False  # main.py: sample from noise, not recon


# Registry matching SURVEY §2.7 / the reference's script roster.
MODES = {
    # code/train_diffusion.py — unconditional, 3 CLI args (:74-79)
    "uncond": ModeSpec(
        name="uncond",
        prefix="BIGnoiselr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}",
        conditional=False,
        timing_log=False,
        track_val_mse=False,
        mean_correction=True,
        param_grid=False,
        guidance_sweep=False,
        sensitivity=False,
        ckpt_style="list25",
    ),
    # code/train_diffusion_condition.py (:81)
    "condition": ModeSpec(
        name="condition",
        prefix=(
            "conditional_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_params_{num_params}"
        ),
        timing_log=False,
    ),
    # code/train_diffusion_condition_viridis.py (:81)
    "condition_viridis": ModeSpec(
        name="condition_viridis",
        prefix=(
            "conditional_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_params_{num_params}"
        ),
        timing_log=False,
        viridis=True,
    ),
    # code/train_diffusion_likelihood.py (:126)
    "likelihood": ModeSpec(
        name="likelihood",
        prefix=(
            "likelihood_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_params_{num_params}"
        ),
        eval_nll=True,
    ),
    # code/train_diffusion_elbo.py (:159) — per-batch ELBO/BPD during training
    # plus, at each eval point, val ELBO/BPD (per-batch form over the test
    # loader) and a test-subset NLL with timing line (:358-415), and the
    # 4-panel training_metrics.png with per-epoch ELBO/BPD curves (:438-487).
    "elbo": ModeSpec(
        name="elbo",
        prefix=(
            "elbo_bpd_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_params_{num_params}"
        ),
        per_batch_elbo=True,
        training_metrics_figure=True,
    ),
    # code/train_diffusion_paper.py / paper1.py (:193)
    "paper": ModeSpec(
        name="paper",
        prefix=(
            "paper_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_params_{num_params}"
        ),
        eval_elbo=True,
        eval_nll=True,
        post_metrics=True,
        viridis=True,
        training_metrics_figure=True,
    ),
    # code/train_diffusion_paper1.py — identical to paper.py except the
    # publication plot styling (diff confirms, SURVEY §2.7): fontsize 25/28,
    # no bold, metric suffix dropped from series labels (viz._PLOT_STYLES).
    "paper1": ModeSpec(
        name="paper1",
        prefix=(
            "paper_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_params_{num_params}"
        ),
        eval_elbo=True,
        eval_nll=True,
        post_metrics=True,
        viridis=True,
        training_metrics_figure=True,
        plot_style="paper1",
    ),
    # code/train_diffusion_spectrum_final.py (:193) — paper suite, plain
    # plots, test-set NLL only, no power spectrum despite the name.
    "spectrum_final": ModeSpec(
        name="spectrum_final",
        prefix=(
            "elbo_bpd_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_params_{num_params}"
        ),
        eval_elbo=True,
        eval_nll=True,
        val_nll_only=True,
        post_metrics=True,
        styled_plots=False,
        training_metrics_figure=True,
    ),
    # initial.py — early 128x128 unconditional 3-level variant (:15-75,
    # z-score+clip normalization :114-126, prefix :88-89)
    "initial": ModeSpec(
        name="initial",
        prefix="lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}",
        conditional=False,
        timing_log=False,
        track_val_mse=False,
        param_grid=False,
        guidance_sweep=False,
        sensitivity=False,
        model_variant="deep",
        data_style="initial",
        def_height=128,
        ckpt_every=4,
        ckpt_style="mod0",
    ),
    # initial2.py — 64x64 unconditional variant (prefix :79)
    "initial2": ModeSpec(
        name="initial2",
        prefix="BIGmassnoiselr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}",
        conditional=False,
        timing_log=False,
        track_val_mse=False,
        mean_correction=True,
        param_grid=False,
        guidance_sweep=False,
        sensitivity=False,
        ckpt_every=4,
        ckpt_style="mod0",
    ),
    # main.py — "big" n_feat=256 128x128 variant with STANDARD q_sample
    # scaling (main.py:156) and fresh-noise sampling (:197-205)
    "main": ModeSpec(
        name="main",
        prefix="lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}",
        conditional=False,
        timing_log=False,
        track_val_mse=False,
        param_grid=False,
        guidance_sweep=False,
        sensitivity=False,
        model_variant="big",
        data_style="big",
        q_scaling="standard",
        def_height=128,
        def_n_feat=256,
        def_n_cfeat=10,
        pure_noise_sampling=True,
        ckpt_every=4,
        ckpt_style="mod0",
    ),
    # 26thNovCode.py — minimal unconditional variant (prefix :83)
    "nov26": ModeSpec(
        name="nov26",
        prefix="lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}",
        conditional=False,
        timing_log=False,
        track_val_mse=False,
        param_grid=False,
        guidance_sweep=False,
        sensitivity=False,
        ckpt_every=4,
        ckpt_style="mod0",
    ),
    # code/train_diffusion_spectrum_indiv.py (:158)
    "spectrum_indiv": ModeSpec(
        name="spectrum_indiv",
        prefix=(
            "spectrum_lr_{lrate}_epochs_{n_epoch}_timesteps_{timesteps}"
            "_param_{param_index}"
        ),
        per_batch_elbo=True,
        param_index_mode=True,
        recon_power_spectra=True,
        viridis=True,
        guidance_sweep=False,
        training_metrics_figure=True,
    ),
}


@dataclasses.dataclass
class ExperimentConfig:
    mode: str
    lrate: float
    n_epoch: int
    timesteps: int
    num_params: int = 6
    param_index: Optional[int] = None

    # Reference module constants, now configurable:
    beta1: float = 1e-4
    beta2: float = 0.02
    n_feat: int = 128
    height: int = 64
    batch_size: int = 32
    test_size: int = 1500
    eval_every: int = 5
    ckpt_every: int = 25
    guidance_strengths: Tuple[float, ...] = (0.0, 1.0, 2.0, 3.0, 5.0)
    maps_path: str = "../data/Maps_HI_IllustrisTNG_LH_z=0.00.npy"
    params_path: str = "../data/params.npy"
    output_root: str = "outputs"
    seed: int = 42

    # Knobs without a reference counterpart:
    dtype: str = "float32"  # model compute dtype: "float32" | "bfloat16"
    # init_conv residual-projection mode: "learned" (default, correct design)
    # or "stochastic" (reference-faithful fresh random 1x1 conv per forward,
    # diffusion_utilities.py:54), which only the JAX package runs.
    shortcut: str = "learned"
    n_eval_images: int = 10
    elbo_subset: int = 2000
    nll_subset: int = 200
    # Eval-pass device batch (per-sample means are batch-size invariant, so a
    # big batch just amortizes the T-step sweeps):
    eval_batch_size: int = 256
    max_maps: Optional[int] = None  # subsample for smoke runs
    synthetic_fallback: bool = True  # use synthetic data if files missing
    synthetic_param_sets: int = 32
    data_size: int = 256  # raw map resolution for synthetic generation
    resume: bool = False
    mesh_devices: Optional[int] = None  # data-parallel device count (None=all)

    def __post_init__(self):
        # Apply the mode's model defaults unless explicitly overridden
        # (class defaults are the canonical 64x64 / n_feat=128 values).
        spec = MODES[self.mode]
        if self.height == 64 and spec.def_height != 64:
            self.height = spec.def_height
        if self.n_feat == 128 and spec.def_n_feat != 128:
            self.n_feat = spec.def_n_feat
        if self.ckpt_every == 25 and spec.ckpt_every != 25:
            self.ckpt_every = spec.ckpt_every

    @property
    def spec(self) -> ModeSpec:
        return MODES[self.mode]

    @property
    def n_cfeat(self) -> int:
        # Unconditional scripts still build the model with a zero context
        # vector: n_cfeat=5 (train_diffusion.py:90) or the variant's own
        # default (main.py: n_cfeat=10).
        if self.spec.def_n_cfeat:
            return self.spec.def_n_cfeat
        return 5 if not self.spec.conditional else self.num_params

    @property
    def output_tag(self) -> str:
        return self.spec.prefix.format(
            lrate=self.lrate,
            n_epoch=self.n_epoch,
            timesteps=self.timesteps,
            num_params=self.num_params,
            param_index=self.param_index,
        )

    def output_dir(self) -> str:
        import os

        return os.path.join(self.output_root, self.output_tag)


def config_from_argv(mode: str, argv, **overrides) -> ExperimentConfig:
    """Parse the reference's positional CLI.

    4-arg form (README.md:68): ``lr epochs timesteps num_params``.
    3-arg form (train_diffusion.py:74-76): ``lr epochs timesteps`` -> uncond.
    spectrum_indiv: 4th arg is ``param_index`` (0-based column).
    """
    spec = MODES[mode]
    n_args = 4 if (spec.conditional or spec.param_index_mode) else 3
    if len(argv) < n_args:
        forms = "<lr> <epochs> <timesteps>" + (
            " <param_index>" if spec.param_index_mode
            else " <num_params>" if spec.conditional else ""
        )
        raise SystemExit(f"usage: train_diffusion_{mode}.py {forms}")
    lrate = float(argv[0])
    n_epoch = int(argv[1])
    timesteps = int(argv[2])
    kw = dict(mode=mode, lrate=lrate, n_epoch=n_epoch, timesteps=timesteps)
    if spec.param_index_mode:
        kw["param_index"] = int(argv[3])
        kw["num_params"] = 1
    elif spec.conditional:
        kw["num_params"] = int(argv[3])
    kw.update(overrides)
    return ExperimentConfig(**kw)
