"""Run configuration: the reference's YAML schema, parsed into typed objects.

Port of ``nerf_and_dietnerf_tpu/utils/config.py``: the same fields, sections,
strict keys and backend names, so every stock ``config_files/*.yaml`` loads
unchanged. ``nerf_config()`` builds the port's ``NeRFConfig`` (torch dtypes;
"pallas" / "pallas_mlp" select the CUDA kernels). PyYAML is imported only
inside :func:`load_config`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

from nerf_and_dietnerf_tpu_torch.models.mlp import MLPConfig
from nerf_and_dietnerf_tpu_torch.models.nerf import NeRFConfig


@dataclasses.dataclass
class TasksConfig:
    """The 8 boolean task switches (``src/ConfigurationKeys.py:34-59``),
    executed in the reference's fixed order (``src/ExecutionRun.py:115-152``)."""

    start_training: bool = False
    render_and_save_test_left_to_right_video: bool = False
    render_and_save_test_sphere_video: bool = False
    render_and_save_test_path_video: bool = False
    save_dataset_video: bool = False
    save_plots_video: bool = False
    create_plots_that_visualize_values_along_rays: bool = False
    create_plot_that_visualize_rendering_between_2_images: bool = False


@dataclasses.dataclass
class VideoConfig:
    """``video`` section (``src/ConfigurationKeys.py:134-146``)."""

    fps_train_set_video: int = 5
    fps_render_video: int = 60
    fps_plot_video: int = 5
    img_indices_for_path_video: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RunConfig:
    """One execution run == one YAML file (reference ``ExecutionRun`` ctor,
    ``src/ExecutionRun.py:53-113``)."""

    # General / dataset keys (src/ConfigurationKeys.py:10-29).
    dataset_type: str = "blender"
    dataset_location: str = ""
    general_save_location: str = "Results"
    existing_save_dir_name: Optional[str] = None
    starting_epoch_number: int = -1
    google_cloud_bucket_name: Optional[str] = None
    pics_indices_to_use_in_dataset: Optional[List[int]] = None

    # neural_net section.
    type_of_model: str = "NeRF"
    hidden_layer_dim: int = 256
    last_hidden_layer_dim: int = 128
    leaky_relu_alpha: float = 0.05
    n_pos_enc_dim_xyz: int = 5
    n_pos_enc_view_dir: int = 4
    n_angles_for_model: int = 2
    n_rays_in_batch_train: int = 4096
    n_rays_in_batch_render: int = 4096

    # render section.
    n_render_samples_coarse: int = 64
    n_render_samples_fine: int = 128
    near_depth_render: float = 2.0
    far_depth_render: float = 6.0

    # training section.
    n_epochs: int = 70
    optimizer_lr: float = 5e-4
    test_img_idx: int = 0
    idx_train_img_to_plot: int = 0

    tasks: TasksConfig = dataclasses.field(default_factory=TasksConfig)
    video: VideoConfig = dataclasses.field(default_factory=VideoConfig)

    # Extensions of the JAX package (no reference analog); see its
    # utils/config.py for the measured rationale of each knob.
    mesh_data_devices: Optional[int] = None  # multi-device runs: not ported yet
    compute_dtype: str = "bfloat16"          # train-step matmul operand type
    backend: str = "xla"        # "xla" | "pallas" | "pallas_mlp" | "pallas_rm"
    on_device_epoch: bool = True             # the port always keeps the table on the device
    stop_fine_z_grad: bool = False           # True = bmild/nerf stop-gradient
    init_seed: int = 0                       # parameter-init generator seed
    sigma_bias_init: float = 0.0             # initial bias of the density head
    sigma_noise_std: float = 0.0             # train-time density preactivation noise
    grad_clip_norm: 'Optional[float]' = None      # global-norm clip (None: off)
    optimizer_lr_final: 'Optional[float]' = None  # exponential lr decay target (None: constant)
    offline_render_chunk: 'Optional[int]' = None  # rays per eval-render chunk (None: auto)
    allow_random_embedder: bool = False      # DietNeRF: not ported yet
    config_name: str = "run"                 # stem of the YAML file

    VALID_BACKENDS = ("xla", "pallas", "pallas_mlp", "pallas_rm")

    def __post_init__(self):
        if self.backend not in self.VALID_BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of "
                f"{self.VALID_BACKENDS}"
            )
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"unknown compute_dtype {self.compute_dtype!r}; expected "
                "'bfloat16' or 'float32'"
            )

    def nerf_config(self) -> NeRFConfig:
        """The model/render config derived from this run config."""
        import torch

        return NeRFConfig(
            mlp=MLPConfig(
                hidden_dim=self.hidden_layer_dim,
                last_hidden_dim=self.last_hidden_layer_dim,
                leaky_relu_alpha=self.leaky_relu_alpha,
                n_freq_xyz=self.n_pos_enc_dim_xyz,
                n_freq_dir=self.n_pos_enc_view_dir,
                n_angles=self.n_angles_for_model,
                sigma_bias_init=self.sigma_bias_init,
            ),
            n_samples_coarse=self.n_render_samples_coarse,
            n_samples_fine=self.n_render_samples_fine,
            near=self.near_depth_render,
            far=self.far_depth_render,
            compute_dtype=torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32,
            backend=self.backend,
            stop_fine_z_grad=self.stop_fine_z_grad,
            sigma_noise_std=self.sigma_noise_std,
        )

    OFFLINE_RENDER_CHUNK_AUTO = 32768

    def offline_chunk_size(self) -> int:
        """Rays per chunk of the offline/eval full-frame renders."""
        if self.offline_render_chunk is not None:
            return self.offline_render_chunk
        return max(self.OFFLINE_RENDER_CHUNK_AUTO, self.n_rays_in_batch_render)

    @property
    def is_dietnerf(self) -> bool:
        return self.type_of_model.lower() == "dietnerf"


# Keys present in some stock reference configs but read nowhere in the
# reference code (verified absent from src/ConfigurationKeys.py) — accepted
# and ignored for config-file compatibility.
LEGACY_IGNORED_KEYS = {
    "video_total_x_distance_l_to_r",
    "video_z_closest_distance",
    "video_sphere_radius",
    "epoch_num_to_reach_high_lr",
    "epoch_num_to_reach_low_lr",
    "optimizer_low_lr",
}


def load_config(path) -> RunConfig:
    """Parse a reference-format YAML into a :class:`RunConfig`
    (reference ``src/UtilsFiles.py:182-194``). Unknown keys are rejected so
    typos fail loudly (the reference silently ignores them), except the
    known-dead legacy keys above."""
    import yaml

    path = Path(path)
    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    cfg = RunConfig(config_name=path.stem)
    sections = {
        "neural_net": None,
        "render": None,
        "training": None,
        "tasks_to_perform": "tasks",
        "video": "video",
        "mesh": None,
    }
    flat_fields = {f.name for f in dataclasses.fields(RunConfig)}

    def set_flat(key, value, where):
        if key in LEGACY_IGNORED_KEYS:
            return
        mapped = {"data_devices": "mesh_data_devices"}.get(key, key)
        if mapped not in flat_fields:
            raise ValueError(f"unknown config key {key!r} in {where} of {path}")
        setattr(cfg, mapped, value)

    for key, value in raw.items():
        if key in ("tasks_to_perform", "video"):
            target = getattr(cfg, sections[key])
            valid = {f.name for f in dataclasses.fields(target)}
            for k, v in (value or {}).items():
                if k in LEGACY_IGNORED_KEYS:
                    continue
                if k not in valid:
                    raise ValueError(f"unknown key {k!r} in section {key} of {path}")
                setattr(target, k, v)
        elif key in sections:
            for k, v in (value or {}).items():
                set_flat(k, v, key)
        else:
            set_flat(key, value, "top level")
    return cfg
