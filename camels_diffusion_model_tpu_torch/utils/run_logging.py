"""Plain-text run logs with the reference's line formats (counterpart of
``camels_diffusion_model_tpu/utils/run_logging.py``, the lines a run
writes).

``timing_and_performance.log`` (header, per-epoch timing and metric
blocks, sampling, the parameter grid, guidance and sensitivity lines),
``dataset_info.txt``, ``selected_params.txt`` and a per-epoch device line in
``output.log`` inside the run's directory.  The device line
names the platform as the JAX package does (``GPU`` or ``CPU``) and, on a
card, the card by ``torch.cuda.get_device_name``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch


def device_name(device) -> str:
    """``GPU (<card name>)`` for a CUDA device, ``CPU`` otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"GPU ({torch.cuda.get_device_name(device)})"
    return "CPU"


def log_device_used(device, output_file: str = "output.log") -> None:
    """Append the reference's ``Device used: <platform>`` line
    (``train_diffusion_paper.py:72-75``; ``run_logging.py:21-27`` of the
    JAX package) to ``output_file``: ``GPU`` for a CUDA device, ``CPU``
    otherwise."""
    used = "GPU" if torch.device(device).type == "cuda" else "CPU"
    with open(output_file, "a") as f:
        f.write(f"Device used: {used}\n")


class RunLogger:
    """Writer of the ``outputs/<tag>/`` log files of a run on ``device``."""

    def __init__(self, output_dir: str, device):
        self.output_dir = output_dir
        self.device = torch.device(device)
        os.makedirs(output_dir, exist_ok=True)
        self.timing_log_path = os.path.join(output_dir, "timing_and_performance.log")

    def write_header(self, lrate: float, n_epoch: int, timesteps: int,
                     num_params: Optional[int]) -> None:
        with open(self.timing_log_path, "w") as f:
            f.write("=== Diffusion Model Training and Sampling Timing Log ===\n\n")
            f.write(f"Parameters: learning_rate={lrate}, epochs={n_epoch}, "
                    f"timesteps={timesteps}")
            f.write("\n\n" if num_params is None else f", num_params={num_params}\n\n")

    def append(self, text: str) -> None:
        with open(self.timing_log_path, "a") as f:
            f.write(text)

    def epoch(self, ep: int, n_epoch: int, duration: float, loss: float) -> None:
        self.append(
            f"Epoch {ep + 1}/{n_epoch} completed in {duration:.2f} seconds\n"
            f"  Training Loss: {loss:.6f}\n"
        )

    def eval_metrics(self, val_loss: float, train_elbo: float, train_bpd: float,
                     val_elbo: float, val_bpd: float, train_nll: float,
                     val_nll: float, nll_seconds: float) -> None:
        self.append(
            f"  Validation Loss: {val_loss:.6f}\n"
            f"  Train ELBO: {train_elbo:.6f}, Train BPD: {train_bpd:.6f}\n"
            f"  Val ELBO: {val_elbo:.6f}, Val BPD: {val_bpd:.6f}\n"
            f"  Train Negative Log Likelihood: {train_nll:.6f}\n"
            f"  Val Negative Log Likelihood: {val_nll:.6f}\n"
            f"  Likelihood calculation took {nll_seconds:.2f} seconds\n"
        )

    def training_complete(self, total_seconds: float, epoch_times: Iterable[float],
                          final_train_loss: float, final_val_loss: Optional[float] = None,
                          final_train_bpd: Optional[float] = None,
                          final_val_bpd: Optional[float] = None,
                          final_train_nll: Optional[float] = None,
                          final_val_nll: Optional[float] = None) -> None:
        self.append(
            "\n=== Training Complete ===\n"
            f"Total training time: {total_seconds:.2f} seconds "
            f"({total_seconds / 3600:.2f} hours)\n"
            f"Average time per epoch: {np.mean(list(epoch_times)):.2f} seconds\n"
            f"Final training loss: {final_train_loss:.6f}\n"
        )
        finals = (
            ("Final validation loss: {:.6f}\n", final_val_loss),
            ("Final training BPD: {:.6f}\n", final_train_bpd),
            ("Final validation BPD: {:.6f}\n", final_val_bpd),
            ("Final training negative log likelihood: {:.6f}\n", final_train_nll),
            ("Final validation negative log likelihood: {:.6f}\n\n", final_val_nll),
        )
        for fmt, value in finals:
            if value is not None:
                self.append(fmt.format(value))

    def sampling_header(self) -> None:
        self.append("\n=== Sampling Performance ===\n")

    def reconstruction_perf(self, n_images: int, seconds: float, per_step: float,
                            timesteps: int) -> None:
        self.append(
            f"Reconstructing {n_images} test images took {seconds:.2f} seconds\n"
            f"Average time per timestep: {per_step:.4f} seconds\n"
            f"Total timesteps: {timesteps}\n"
        )

    def grid_perf(self, n_samples: int, seconds: float) -> None:
        self.append(f"Generating {n_samples} parameter grid samples took "
                    f"{seconds:.2f} seconds\n")

    def sample_metrics(self, label: str, elbo: float, bpd: float, nll: float) -> None:
        self.append(
            f"ELBO of {label}: {elbo:.6f}\n"
            f"BPD of {label}: {bpd:.6f}\n"
            f"Negative log likelihood of {label}: {nll:.6f}\n"
        )

    def guidance_metrics(self, w: float, elbo: float, bpd: float, nll: float) -> None:
        self.append(f"Guidance strength {w} - ELBO: {elbo:.6f}, "
                    f"BPD: {bpd:.6f}, NLL: {nll:.6f}\n")

    def sensitivity_header(self, param_idx: int) -> None:
        self.append(f"\nParameter {param_idx + 1} sensitivity metrics:\n")

    def sensitivity_value(self, value: float, elbo: float, bpd: float, nll: float) -> None:
        self.append(f"  Value {value:.2f} - ELBO: {elbo:.6f}, "
                    f"BPD: {bpd:.6f}, NLL: {nll:.6f}\n")

    def dataset_info(self, info: Dict[str, object]) -> None:
        with open(os.path.join(self.output_dir, "dataset_info.txt"), "w") as f:
            f.write(f"Total dataset size: {info['total']}\n")
            f.write(f"Train dataset size: {info['train']}\n")
            f.write(f"Test dataset size: {info['test']}\n")
            f.write(f"Number of parameters used for conditioning: {info['num_params']}\n")
            f.write(f"Original parameter data shape: {info['original_param_shape']}\n")
            f.write(f"Expanded parameter data shape: {info['expanded_param_shape']}\n")
            f.write(f"Final normalized parameter data shape: {info['final_param_shape']}\n")

    def selected_params(self, params: np.ndarray) -> None:
        text = "".join(f"Image {i + 1}: {[f'{p:.4f}' for p in row]}\n"
                       for i, row in enumerate(np.asarray(params)))
        with open(os.path.join(self.output_dir, "selected_params.txt"), "w") as f:
            f.write(text)

    def device_line(self) -> None:
        """``Device used: ...`` appended to the run's ``output.log``
        (``train_diffusion_paper.py:72-75``), once an epoch."""
        with open(os.path.join(self.output_dir, "output.log"), "a") as f:
            f.write(f"Device used: {device_name(self.device)}\n")
