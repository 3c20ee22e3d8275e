"""Evaluation loop: reconstruction and imagination metrics over the test
samplers (counterpart of muvo_tpu/training/evaluator.py).

Upstream MUVO's test protocol (muvo/trainer.py:1079-1095, 426-567):
observe RECEPTIVE_FIELD frames once a batch, imagine FUTURE_HORIZON frames
PREDICTION.N_SAMPLES times from the last posterior state, and accumulate
BEV, LiDAR and camera IoU, SSIM, PSNR, Chamfer distance and the SSC voxel
metrics apart for the reconstruction and the imagination.

Random streams. muvo_tpu derives batch i's keys from ``fold_in(PRNGKey(7),
i)``, and sample s's from a further ``fold_in(.., s)``. The port seeds a
``torch.Generator`` on the device with the first 64-bit word of
``numpy.random.SeedSequence((7, i))`` for batch i's observation, and with
that of ``SeedSequence((7, i, s))`` for its imagination sample s
(``eval_generator``). So the observation's draws do not move with
N_SAMPLES, and each sample's draws do not move with the batches before it.
Each generator draws its step's noise first, then the 10,000 LiDAR columns
of that step's Chamfer distance, on the device.

In a group of ranks each rank evaluates its slice of every batch with the
same generators: the RSSM draws the global batch's noise and keeps its
rows (parallel/mesh.py:randn_slice), the Chamfer columns are every rank's
alike, and ``MetricSuite.compute`` sums the accumulators over the ranks,
so the metrics are one process's on the same global batches.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from muvo_tpu_torch import metrics as M
from muvo_tpu_torch.data.loader import device_prefetch
from muvo_tpu_torch.parallel import mesh

CLASS_NAMES_BEV = [
    "Background", "Road", "Lane marking", "Vehicle", "Pedestrian",
    "Green light", "Yellow light", "Red light and stop sign",
]
TEST_SEED = 7
CHAMFER_COLUMNS = 10000  # upstream samples 10,000 columns with replacement


def eval_generator(device, *path: int) -> torch.Generator:
    """The generator of an evaluation step: seeded from (TEST_SEED,
    *path) through numpy's SeedSequence."""
    entropy = np.random.SeedSequence((TEST_SEED, *path)).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(entropy[0]))


class MetricSuite:
    """The enabled metrics' states, on the device of the batches they
    accumulate; ``compute`` reads them to the host once."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def reset(self):
        cfg, dev = self.cfg, self.device
        self.state: Dict = {}
        if cfg.SEMANTIC_SEG.ENABLED:
            self.state["iou"] = M.jaccard_init(cfg.SEMANTIC_SEG.N_CHANNELS,
                                               dev)
        if cfg.EVAL.RGB_SUPERVISION:
            self.state["ssim"] = M.mean_init(dev)
            self.state["psnr"] = M.mean_init(dev)
        if cfg.LIDAR_RE.ENABLED:
            self.state["cd"] = M.mean_init(dev)
        if cfg.LIDAR_SEG.ENABLED:
            self.state["pcd_iou"] = M.jaccard_init(cfg.LIDAR_SEG.N_CLASSES,
                                                   dev)
        if cfg.SEMANTIC_IMAGE.ENABLED:
            self.state["image_iou"] = M.jaccard_init(
                cfg.SEMANTIC_IMAGE.N_CLASSES, dev)
        if cfg.VOXEL_SEG.ENABLED:
            self.state["ssc"] = M.ssc_init(cfg.VOXEL_SEG.N_CLASSES, dev)

    def update(self, batch: Dict, output: Dict,
               generator: Optional[torch.Generator] = None):
        """Adds one step's (b, s, ...) labels and outputs. ``generator``
        draws the Chamfer distance's LiDAR columns on its device (one on
        the outputs' device seeded 0 when None)."""
        cfg = self.cfg
        if cfg.SEMANTIC_SEG.ENABLED:
            self.state["iou"] = M.jaccard_update(
                self.state["iou"], output["bev_segmentation_1"].argmax(-1),
                batch["birdview_label"][..., 0], cfg.SEMANTIC_SEG.N_CHANNELS)
        if cfg.EVAL.RGB_SUPERVISION:
            self.state["ssim"] = M.mean_update(
                self.state["ssim"],
                M.ssim_batch(output["rgb_1"], batch["rgb_label_1"]))
            self.state["psnr"] = M.mean_update(
                self.state["psnr"],
                M.psnr_batch(output["rgb_1"], batch["rgb_label_1"]))
        if cfg.LIDAR_RE.ENABLED:
            scale = cfg.LIDAR_RE.SCALE
            target = batch["range_view_label_1"] * scale
            pred = output["lidar_reconstruction_1"] * scale
            b, s, h, w, c = pred.shape
            pcd_t = target.reshape(b * s, h * w, c)[..., :-1]
            pcd_p = pred.reshape(b * s, h * w, c)[..., :-1]
            if generator is None:
                generator = torch.Generator(device=pred.device).manual_seed(0)
            idx = torch.randint(0, h * w, (CHAMFER_COLUMNS,),
                                generator=generator,
                                device=generator.device).to(pred.device)
            self.state["cd"] = M.mean_update(
                self.state["cd"], M.chamfer_batch(pcd_p[:, idx],
                                                  pcd_t[:, idx]))
        if cfg.LIDAR_SEG.ENABLED:
            self.state["pcd_iou"] = M.jaccard_update(
                self.state["pcd_iou"],
                output["lidar_segmentation_1"].argmax(-1),
                batch["range_view_seg_label_1"][..., 0],
                cfg.LIDAR_SEG.N_CLASSES)
        if cfg.SEMANTIC_IMAGE.ENABLED:
            self.state["image_iou"] = M.jaccard_update(
                self.state["image_iou"],
                output["semantic_image_1"].argmax(-1),
                batch["semantic_image_label_1"][..., 0],
                cfg.SEMANTIC_IMAGE.N_CLASSES)
        if cfg.VOXEL_SEG.ENABLED:
            pred = output["voxel_1"].argmax(-1)
            b, s = pred.shape[:2]
            self.state["ssc"] = M.ssc_update(
                self.state["ssc"], pred.reshape((b * s,) + pred.shape[2:]),
                batch["voxel_label_1"].reshape((b * s,) + pred.shape[2:]),
                cfg.VOXEL_SEG.N_CLASSES)

    def compute(self) -> Dict[str, float]:
        """The metrics of everything added; in a group of ranks, of every
        rank's batches (the accumulators summed over the ranks first, so
        every rank must call it)."""
        state = self.summed_state()
        cfg = self.cfg
        out: Dict[str, float] = {}
        if cfg.SEMANTIC_SEG.ENABLED:
            scores = M.jaccard_compute(state["iou"]).cpu().numpy()
            for name, val in zip(CLASS_NAMES_BEV, scores):
                out[f"bev_iou_{name}"] = float(val)
            out["bev_mean_iou"] = float(scores.mean())
        if cfg.EVAL.RGB_SUPERVISION:
            out["ssim"] = M.mean_compute(state["ssim"]).item()
            out["psnr"] = M.mean_compute(state["psnr"]).item()
        if cfg.LIDAR_RE.ENABLED:
            out["chamfer_distance"] = M.mean_compute(state["cd"]).item()
        if cfg.LIDAR_SEG.ENABLED:
            scores = M.jaccard_compute(state["pcd_iou"]).cpu().numpy()
            out["lidar_mean_iou"] = float(scores.mean())
        if cfg.SEMANTIC_IMAGE.ENABLED:
            scores = M.jaccard_compute(state["image_iou"]).cpu().numpy()
            out["camera_mean_iou"] = float(scores.mean())
        if cfg.VOXEL_SEG.ENABLED:
            stats = M.ssc_compute(state["ssc"])
            out["voxel_precision"] = stats["precision"].item()
            out["voxel_recall"] = stats["recall"].item()
            out["voxel_iou"] = stats["iou"].item()
            out["voxel_iou_ssc_mean"] = stats["iou_ssc_mean"].item()
        return out

    def summed_state(self) -> Dict:
        """The accumulators (confusion matrices, SSC counts, the (sum,
        count) means), each summed over the ranks of a group (a copy)."""
        if not mesh.is_active():
            return self.state
        state = {k: ({n: t.clone() for n, t in v.items()}
                     if isinstance(v, dict) else v.clone())
                 for k, v in self.state.items()}
        mesh.sum_over_ranks([t for v in state.values() for t in (
            v.values() if isinstance(v, dict) else [v])])
        return state


class Evaluator:
    """Runs the test protocol over a loader: encode once, imagine
    PREDICTION.N_SAMPLES times."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.cfg = trainer.cfg
        self.rf = trainer.rf
        self.fh = trainer.fh
        self.n_samples = self.cfg.PREDICTION.N_SAMPLES

    def run(self, loader: Iterable[Dict],
            max_batches: Optional[int] = None
            ) -> Tuple[Dict[str, float], Dict[str, float]]:
        """(reconstruction metrics, imagination metrics) over ``loader``'s
        raw batches, at most ``max_batches`` of them."""
        dev = self.trainer.device
        recon = MetricSuite(self.cfg, dev)
        imagine = MetricSuite(self.cfg, dev)
        can_imagine = self.trainer.imagines
        with contextlib.closing(device_prefetch(iter(loader), dev)) as batches:
            for i, batch in enumerate(batches):
                if max_batches is not None and i >= max_batches:
                    break
                self._batch(i, batch, recon, imagine, can_imagine)
        return recon.compute(), imagine.compute()

    def _batch(self, i, batch, recon, imagine, can_imagine):
        """Observe batch ``i`` once, imagine it n_samples times, and add
        both to the metrics."""
        trainer, dev = self.trainer, self.trainer.device
        step_gen = eval_generator(dev, i)
        obs = trainer.observe_step(batch, step_gen)
        pb = obs["pb"]
        if can_imagine:
            batch_fh = {k: v[:, self.rf:] for k, v in pb.items()}
            for s in range(self.n_samples):
                sample_gen = eval_generator(dev, i, s)
                out = trainer.imagine_step(pb, obs["hidden_state"],
                                           obs["sample"], sample_gen)
                imagine.update(batch_fh, out["output_imagine"], sample_gen)
        recon.update({k: v[:, :self.rf] for k, v in pb.items()},
                     obs["output"], step_gen)
