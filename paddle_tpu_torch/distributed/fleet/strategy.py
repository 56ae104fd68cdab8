"""DistributedStrategy — counterpart of
``paddle_tpu/distributed/fleet/strategy.py`` (the reference's
fleet/base/distributed_strategy.py:104 over
framework/distributed_strategy.proto:158-209).

A plain serializable dataclass with the JAX package's fields, defaults
and JSON form, so a strategy saved by either package loads in the other.
Its compiler (``fleet/strategy_compiler.py``) is not ported: it needs
the Paddle-compat layers.  Imports no torch.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sp_degree: int = 1  # sequence/context parallel — beyond-reference axis
    # (the zigzag causal load-balancing LAYOUT is a model-level choice, not
    # a mesh degree: see build_gpt_train_step(sp_zigzag=True))


@dataclass
class AMPConfig:
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    use_dynamic_loss_scaling: bool = True
    custom_white_list: list = field(default_factory=list)
    custom_black_list: list = field(default_factory=list)
    use_pure_bf16: bool = True  # bf16, no loss scaling (as the JAX package)


@dataclass
class RecomputeConfig:
    checkpoints: list = field(default_factory=list)
    policy: str = "full"  # full | dots_saveable | nothing_saveable


@dataclass
class ShardingConfig:
    sharding_degree: int = 1
    stage: int = 1  # 1: opt state; 2: +grads; 3: +params  (ZeRO stages)
    offload: bool = False


@dataclass
class PipelineConfig:
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"  # F-then-B | 1F1B (reference section_worker.cc:130)


@dataclass
class GradientMergeConfig:
    k_steps: int = 1
    avg: bool = True


@dataclass
class LocalSGDConfig:
    k_steps: int = 1
    begin_step: int = 1


@dataclass
class DGCConfig:
    rampup_begin_step: int = 0
    sparsity: float = 0.999


@dataclass
class DistributedStrategy:
    # switches (reference proto fields)
    amp: bool = False
    recompute: bool = False
    sharding: bool = False
    pipeline: bool = False
    tensor_parallel: bool = False
    sequence_parallel: bool = False  # beyond-reference (SURVEY §2.3 gap)
    gradient_merge: bool = False
    lamb: bool = False
    lars: bool = False
    localsgd: bool = False
    dgc: bool = False
    fp16_allreduce: bool = False
    find_unused_parameters: bool = False
    fuse_all_reduce_ops: bool = True
    fuse_grad_size_in_MB: int = 32
    nccl_comm_num: int = 1  # kept for API parity (the JAX package's default)
    hierarchical_allreduce: bool = False
    a_sync: bool = False  # parameter-server async mode
    # sub-configs
    hybrid_configs: HybridConfig = field(default_factory=HybridConfig)
    amp_configs: AMPConfig = field(default_factory=AMPConfig)
    recompute_configs: RecomputeConfig = field(default_factory=RecomputeConfig)
    sharding_configs: ShardingConfig = field(default_factory=ShardingConfig)
    pipeline_configs: PipelineConfig = field(default_factory=PipelineConfig)
    gradient_merge_configs: GradientMergeConfig = field(default_factory=GradientMergeConfig)
    localsgd_configs: LocalSGDConfig = field(default_factory=LocalSGDConfig)
    dgc_configs: DGCConfig = field(default_factory=DGCConfig)

    def __setattr__(self, name, value):
        # accept dicts for sub-configs (reference API style:
        # strategy.hybrid_configs = {"dp_degree": 2, ...})
        current = self.__dict__.get(name)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            for k, v in value.items():
                if hasattr(current, k):
                    setattr(current, k, v)
            return
        object.__setattr__(self, name, value)

    # serialization (the proto-backed reference is wire-serializable)
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "DistributedStrategy":
        data = json.loads(s)
        strat = cls()
        for k, v in data.items():
            setattr(strat, k, v)
        return strat

    def save_to_prototxt(self, path):
        with open(path, "w") as f:
            f.write(self.to_json())

    def load_from_prototxt(self, path):
        with open(path) as f:
            data = json.loads(f.read())
        for k, v in data.items():
            setattr(self, k, v)

    def mesh_shape(self) -> dict:
        h = self.hybrid_configs
        return {"dp": h.dp_degree, "mp": h.mp_degree, "pp": h.pp_degree,
                "sharding": h.sharding_degree, "sp": h.sp_degree}
