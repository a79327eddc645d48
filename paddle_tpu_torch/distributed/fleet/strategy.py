"""DistributedStrategy (port of paddle_tpu's `distributed/fleet/
strategy.py`), with the same field names. The port trains on one device:
`amp` with `amp_configs.use_pure_bf16`, and `recompute` with
`recompute_configs.policy` ("dots_saveable", "nothing_saveable" or None)
are what run; every toggle that needs a mesh or a rewritten step (dp > 1,
sharding, tensor / sequence / expert / pipeline parallelism, gradient
merge, localsgd, dgc, lars, lamb, ...), recompute checkpoints and any
other recompute policy raise `NotImplementedError` from `check_ported`,
which `compile_train_step` calls when the model is prepared.
`build_mesh` is the JAX package's on one device: its mesh has every
axis (pp, dp, ep, sp, tp) of size 1, and more devices raise."""
from __future__ import annotations

import dataclasses

from .. import mesh as mesh_mod
from .utils import RECOMPUTE_POLICIES

__all__ = ["DistributedStrategy", "AMPConfig", "HybridConfig",
           "RecomputeConfig"]


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = -1          # -1: fill with remaining devices
    mp_degree: int = 1           # tensor parallel
    pp_degree: int = 1           # pipeline
    sharding_degree: int = 1
    sep_degree: int = 1          # sequence parallel
    ep_degree: int = 1           # expert parallel


@dataclasses.dataclass
class RecomputeConfig:
    """The JAX package's fields: `policy` names a checkpoint policy (here
    "dots_saveable", "nothing_saveable" or None); named `checkpoints`
    (segment boundaries) are not ported and raise at prepare."""
    checkpoints: list = dataclasses.field(default_factory=list)
    policy: str = "dots_saveable"


@dataclasses.dataclass
class AMPConfig:
    """The JAX package's fields. The bf16 step reads only `use_pure_bf16`
    (loss scaling is unused there, as in the JAX step); non-empty custom
    op lists raise at prepare."""
    init_loss_scaling: float = 2.0 ** 15
    use_dynamic_loss_scaling: bool = True
    custom_white_list: list = dataclasses.field(default_factory=list)
    custom_black_list: list = dataclasses.field(default_factory=list)
    use_pure_bf16: bool = False


# toggles of the JAX strategy the port does not run; each False by default
_UNPORTED = ("sharding", "pipeline", "gradient_merge",
             "tensor_parallel", "sequence_parallel", "expert_parallel",
             "localsgd", "adaptive_localsgd", "dgc", "fp16_allreduce",
             "lars", "lamb")


class DistributedStrategy:
    """Mutable strategy object with paddle's toggles-as-properties shape."""

    def __init__(self):
        self.amp = False
        self.amp_configs = AMPConfig()
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        for name in _UNPORTED:
            setattr(self, name, False)
        self.hybrid_configs = HybridConfig()
        self.scan_layers = True         # accepted: the port always loops

    def check_ported(self):
        """Raise `NotImplementedError` for any toggle or degree the port
        does not run (one device, no step rewrite)."""
        on = [name for name in _UNPORTED if getattr(self, name)]
        on += [f"{k}={v}" for k, v in
               dataclasses.asdict(self.hybrid_configs).items()
               if v != 1 and not (k == "dp_degree" and v == -1)]
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
                f"paddle_tpu_torch (single-device training: amp, "
                f"amp_configs.use_pure_bf16 and per-block recompute with "
                f"policy in {RECOMPUTE_POLICIES} only)")

    def build_mesh(self, devices=None):
        """The strategy's mesh over `devices` (default: the default
        device), axes in the JAX package's order pp, dp, ep, sp, tp, set
        as the current mesh. Every degree is 1 (`check_ported`) and dp is
        the device count, so more than one device raises
        `NotImplementedError` (`distributed.mesh.build_mesh`)."""
        self.check_ported()
        devices = None if devices is None else list(devices)
        n = 1 if devices is None else len(devices)
        mesh = mesh_mod.build_mesh({"pp": 1, "dp": n, "ep": 1, "sp": 1,
                                    "tp": 1}, devices=devices)
        mesh_mod.set_mesh(mesh)
        return mesh

    def __repr__(self):
        on = [k for k in ("amp", "recompute") + _UNPORTED
              if getattr(self, k)]
        return f"DistributedStrategy(enabled={on}, hybrid={self.hybrid_configs})"
