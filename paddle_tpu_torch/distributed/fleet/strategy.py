"""DistributedStrategy (port of paddle_tpu's `distributed/fleet/
strategy.py`), with the JAX package's fields, config dataclasses and
defaults. The port trains on one device, and `check_ported` (which
`compile_train_step` calls when the model is prepared) says what of the
strategy it runs:

  * `amp` with `amp_configs.use_pure_bf16`; `recompute` with
    `recompute_configs.policy` in "dots_saveable", "nothing_saveable" or
    None;
  * `sharding` at `sharding_configs.stage` 1-3: ZeRO over a dp axis of
    size 1 shards nothing, so the step is the plain one;
  * `pipeline` with `hybrid_configs.pp_degree` 1: the JAX step takes its
    plain branch then and reads no `pipeline_configs`;
  * `gradient_merge` (`gradient_merge_configs.k_steps`, `avg`): each step
    splits its batch into k microbatches and sums their gradients;
  * `lars` and `lamb`: the step swaps the optimizer class.

What needs more than one device raises `NotImplementedError` naming ROADMAP
queue 1 item 7: a degree above 1 (dp, mp, pp, sharding, sep, ep),
`tensor_parallel`, `sequence_parallel`, `expert_parallel`, and the
gradient-communication modes `localsgd`, `adaptive_localsgd`, `dgc` and
`fp16_allreduce`. Non-empty `amp_configs.custom_white_list` /
`custom_black_list` and `recompute_configs.checkpoints` raise too: the JAX
compiled step never reads them, and the port does not ignore a user's
setting silently. The parity fields (`find_unused_parameters`,
`fuse_all_reduce_ops`, ...) are kept and change nothing, as in the JAX
package. `build_mesh` is the JAX package's on one device: every axis
(pp, dp, ep, sp, tp) has size 1, and more devices raise."""
from __future__ import annotations

import dataclasses

from .. import mesh as mesh_mod
from ..env import MULTI_DEVICE
from .utils import RECOMPUTE_POLICIES

__all__ = ["DistributedStrategy", "AMPConfig", "HybridConfig",
           "RecomputeConfig", "ShardingConfig", "PipelineConfig",
           "GradientMergeConfig", "LocalSGDConfig", "AdaptiveLocalSGDConfig",
           "DGCConfig"]


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = -1          # -1: fill with remaining devices
    mp_degree: int = 1           # tensor parallel ('tp' axis)
    pp_degree: int = 1           # pipeline ('pp' axis)
    sharding_degree: int = 1     # ZeRO group size over dp
    sep_degree: int = 1          # sequence parallel ('sp' axis)
    ep_degree: int = 1           # expert parallel ('ep' axis, MoE)


@dataclasses.dataclass
class ShardingConfig:
    stage: int = 2
    degree: int = -1
    fuse_broadcast_MB: float = 32.0   # kept for API parity


@dataclasses.dataclass
class PipelineConfig:
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"


@dataclasses.dataclass
class RecomputeConfig:
    """`policy` names a checkpoint policy (here "dots_saveable",
    "nothing_saveable" or None); named `checkpoints` raise at prepare."""
    checkpoints: list = dataclasses.field(default_factory=list)
    policy: str = "dots_saveable"


@dataclasses.dataclass
class AMPConfig:
    """The bf16 step reads only `use_pure_bf16` (loss scaling is unused
    there, as in the JAX step); non-empty custom op lists raise at
    prepare."""
    init_loss_scaling: float = 2.0 ** 15
    use_dynamic_loss_scaling: bool = True
    custom_white_list: list = dataclasses.field(default_factory=list)
    custom_black_list: list = dataclasses.field(default_factory=list)
    use_pure_bf16: bool = False


@dataclasses.dataclass
class GradientMergeConfig:
    k_steps: int = 1
    avg: bool = True


@dataclasses.dataclass
class LocalSGDConfig:
    k_steps: int = 4             # sync params every k local steps
    begin_step: int = 1          # warm-up: sync every step before this


@dataclasses.dataclass
class AdaptiveLocalSGDConfig:
    init_k_steps: int = 1
    begin_step: int = 1


@dataclasses.dataclass
class DGCConfig:
    rampup_begin_step: int = 0   # dense allreduce before this step
    sparsity: float = 0.999      # fraction dropped; keep ratio = 1-sparsity
    momentum: float = 0.9


# toggles that need a mesh of more than one device
_MULTI_TOGGLES = ("tensor_parallel", "sequence_parallel", "expert_parallel",
                  "localsgd", "adaptive_localsgd", "dgc", "fp16_allreduce")


class DistributedStrategy:
    """Mutable strategy object with paddle's toggles-as-properties shape."""

    def __init__(self):
        self.amp = False
        self.amp_configs = AMPConfig()
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        self.sharding = False
        self.sharding_configs = ShardingConfig()
        self.pipeline = False
        self.pipeline_configs = PipelineConfig()
        self.gradient_merge = False
        self.gradient_merge_configs = GradientMergeConfig()
        self.tensor_parallel = False
        self.sequence_parallel = False
        self.sequence_parallel_impl = "ring"   # "ring" | "ulysses"
        self.scan_layers = True         # accepted: the port always loops
        self.expert_parallel = False
        self.hybrid_configs = HybridConfig()
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True     # parity no-op
        self.fuse_grad_size_in_MB = 32      # parity no-op
        self.nccl_comm_num = 1              # parity no-op
        self.localsgd = False
        self.localsgd_configs = LocalSGDConfig()
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = AdaptiveLocalSGDConfig()
        self.dgc = False
        self.dgc_configs = DGCConfig()
        self.fp16_allreduce = False
        self.hierarchical_allreduce = False  # parity no-op
        # the optimizer swap (`compiler._maybe_swap_optimizer`)
        self.lars = False
        self.lamb = False

    def check_ported(self):
        """Raise `NotImplementedError` for any toggle or degree the port
        does not run (see the module docstring)."""
        multi = [name for name in _MULTI_TOGGLES if getattr(self, name)]
        multi += [f"hybrid_configs.{k}={v}" for k, v in
                  dataclasses.asdict(self.hybrid_configs).items()
                  if v != 1 and not (k == "dp_degree" and v == -1)]
        if multi:
            raise NotImplementedError(
                f"DistributedStrategy: {', '.join(multi)} need more than "
                f"one device, which paddle_tpu_torch does not run yet "
                f"({MULTI_DEVICE})")
        on = []
        if self.sharding and self.sharding_configs.stage not in (1, 2, 3):
            on.append(f"sharding_configs.stage="
                      f"{self.sharding_configs.stage!r}")
        k = self.gradient_merge_configs.k_steps
        if self.gradient_merge and k < 1:
            on.append(f"gradient_merge_configs.k_steps={k!r}")
        on += [f"amp_configs.{k}" for k in ("custom_white_list",
                                            "custom_black_list")
               if getattr(self.amp_configs, k)]
        if self.recompute and self.recompute_configs.checkpoints:
            on.append("recompute_configs.checkpoints")
        if self.recompute and (self.recompute_configs.policy
                               not in RECOMPUTE_POLICIES):
            on.append(f"recompute_configs.policy="
                      f"{self.recompute_configs.policy!r}")
        if on:
            raise NotImplementedError(
                f"DistributedStrategy: {', '.join(on)} not ported to "
                f"paddle_tpu_torch (one device: amp with use_pure_bf16, "
                f"per-block recompute with policy in {RECOMPUTE_POLICIES}, "
                f"sharding stages 1-3, pipeline at pp_degree 1, "
                f"gradient_merge, lars, lamb)")

    # -- mesh compilation --------------------------------------------------
    def resolve_degrees(self, n_devices: int):
        """{dp, pp, sp, tp, ep} for `n_devices`, as the JAX package
        resolves them (dp fills what the others leave)."""
        h = self.hybrid_configs
        mp = h.mp_degree if self.tensor_parallel or h.mp_degree > 1 else 1
        pp = h.pp_degree if self.pipeline or h.pp_degree > 1 else 1
        sp = h.sep_degree if self.sequence_parallel or h.sep_degree > 1 else 1
        ep = h.ep_degree if self.expert_parallel or h.ep_degree > 1 else 1
        fixed = mp * pp * sp * ep
        if n_devices % fixed:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"mp*pp*sp*ep={fixed}")
        dp = h.dp_degree if h.dp_degree > 0 else n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"dp({dp})*mp({mp})*pp({pp})*sp({sp})*ep({ep}) "
                f"!= {n_devices}")
        return {"dp": dp, "pp": pp, "sp": sp, "tp": mp, "ep": ep}

    def build_mesh(self, devices=None):
        """The strategy's mesh over `devices` (default: the default
        device), axes in the JAX package's order pp, dp, ep, sp, tp, set
        as the current mesh. Every degree is 1 (`check_ported`) and dp is
        the device count, so more than one device raises
        `NotImplementedError` (`distributed.mesh.build_mesh`)."""
        self.check_ported()
        devices = None if devices is None else list(devices)
        deg = self.resolve_degrees(1 if devices is None else len(devices))
        mesh = mesh_mod.build_mesh({k: deg[k] for k in
                                    ("pp", "dp", "ep", "sp", "tp")},
                                   devices=devices)
        mesh_mod.set_mesh(mesh)
        return mesh

    def sharding_stage(self):
        if not self.sharding:
            return 0
        return int(self.sharding_configs.stage)

    def __repr__(self):
        on = [k for k in ("amp", "recompute", "sharding", "pipeline",
                          "gradient_merge", "tensor_parallel",
                          "sequence_parallel", "expert_parallel")
              if getattr(self, k)]
        return f"DistributedStrategy(enabled={on}, hybrid={self.hybrid_configs})"
