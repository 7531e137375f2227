"""The system under test, built from a configuration file and a seed.

``build`` has the configuration's rig (``benchmark/rigs/<builder>.py``)
make the cell's inputs, the host uint8 frames a camera delivers and their
truth, and builds what the deployment runs on them: ``TorchSlamEngine``,
and where the configuration has them the RGB-D product's
``RGBDProcessor`` and the ``DenseMapper``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.core import spec


@dataclass
class System:
    engine: object
    rig: object  # the rig module's inputs and truth (frames, colors, calibration, gt_poses, ...)
    rgbd: object | None = None
    product_t_body: np.ndarray | None = None  # (4, 4) the RGB-D product's frame in the body
    mapper: object | None = None


def build(cfg: dict, mix: dict, seed: int, device: torch.device) -> System:
    from thor_slam_tpu_torch.engine.torch_engine import TorchSlamEngine
    from thor_slam_tpu_torch.slam.interface import SlamConfig

    if mix["fps"] != cfg["rig"]["fps"]:
        raise ValueError(f"the mix's camera clock ({mix['fps']} fps) differs from the rig's ({cfg['rig']['fps']})")
    rig = spec.rig_builder(cfg["rig"]["builder"]).build(cfg, mix, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)  # the peak is the program's, not the renderer's

    engine = TorchSlamEngine(**cfg["engine"], device=device, seed=int(seed) % 2**63)
    engine.initialize(rig.calibration, SlamConfig(num_cameras=rig.num_cameras, **cfg["slam"]))
    system = System(engine=engine, rig=rig)
    rgbd = cfg.get("rgbd")
    if rgbd and mix.get("rgbd_every"):
        from thor_slam_tpu_torch.pipeline.rgbd import RGBDProcessor

        src = rig.rgbd_source(rgbd["source"])
        proc = RGBDProcessor(
            src["name"], src["intrinsics"], src["extrinsics"], output_resolution=tuple(cfg["rig"]["color_resolution"]),
            num_disparities=rgbd["num_disparities"], color_intrinsics=src["color_intrinsics"],
            left_t_color=src["left_t_color"], device=device,
        )
        system.rgbd = proc
        system.product_t_body = rig.calibration.get_world_extrinsics(src["name"])[0].to_4x4_matrix() @ proc.product_t_in_left
        if cfg.get("mapping") and mix.get("map"):
            from thor_slam_tpu_torch.pipeline.mapper import DenseMapper, MapperConfig

            m = dict(cfg["mapping"])
            m["dims"], m["slice_band_m"] = tuple(m["dims"]), tuple(m["slice_band_m"])
            system.mapper = DenseMapper(MapperConfig(**{k: v for k, v in m.items() if k != "integrate_every"}), device=device)
    return system
