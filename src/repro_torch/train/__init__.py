"""Training substrate: optimizer, step functions, compressed data
parallelism, fault tolerance, carbon-aware scheduling."""

from repro_torch.train.remat import POLICIES, wrap_remat
from repro_torch.train.optimizer import (
    AdamState,
    Optimizer,
    adamw,
    constant_lr,
    global_norm,
    warmup_cosine,
)
from repro_torch.train.train_step import TrainState, init_train_state, make_train_step
from repro_torch.train.compression import MODES as COMPRESSION_MODES
from repro_torch.train.fault import ElasticRunner, StragglerPolicy, make_straggler_train_step
from repro_torch.train.carbon_aware import (
    CarbonAwareTrainer,
    CarbonSchedule,
    LedgerRow,
    PodSpec,
)
