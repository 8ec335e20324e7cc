"""LR schedules constructible from JSON config (the port of
``deepspeed_tpu/runtime/lr_schedules.py``: LRRangeTest, OneCycle with
its momentum cycling, WarmupLR, ``build_lr_schedule`` and the tuning-argument
helpers).

Each schedule is a pure function of the global step, ``lr_at(step)``,
here in Python floats: the engine reads it on the host at every optimizer
boundary and hands the value to the update, as the JAX engine folds it
into its compiled step. The JAX functions compute in fp32, these in
float64, so a value may differ from JAX's in its last fp32 bits. The
object wrapper keeps the torch-scheduler-style
step()/get_lr()/state_dict() facade.
"""

import math
from typing import Optional

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR]


def add_tuning_arguments(parser):
    """Convergence-tuning CLI argument group (reference
    lr_schedules.py:51-149 — same flags, names, and defaults)."""
    group = parser.add_argument_group(
        "Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    # Learning rate range test
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001,
                       help="Starting lr value.")
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0,
                       help="scaling rate for LR range test.")
    group.add_argument("--lr_range_test_step_size", type=int, default=1000,
                       help="training steps per LR change.")
    group.add_argument("--lr_range_test_staircase", type=bool, default=False,
                       help="use staircase scaling for LR range test.")
    # OneCycle schedule
    group.add_argument("--cycle_first_step_size", type=int, default=1000,
                       help="size of first step of 1Cycle schedule "
                            "(training steps).")
    group.add_argument("--cycle_first_stair_count", type=int, default=-1,
                       help="first stair count for 1Cycle schedule.")
    group.add_argument("--cycle_second_step_size", type=int, default=-1,
                       help="size of second step of 1Cycle schedule "
                            "(default first_step_size).")
    group.add_argument("--cycle_second_stair_count", type=int, default=-1,
                       help="second stair count for 1Cycle schedule.")
    group.add_argument("--decay_step_size", type=int, default=1000,
                       help="size of intervals for applying post cycle "
                            "decay (training steps).")
    # 1Cycle LR
    group.add_argument("--cycle_min_lr", type=float, default=0.01,
                       help="1Cycle LR lower bound.")
    group.add_argument("--cycle_max_lr", type=float, default=0.1,
                       help="1Cycle LR upper bound.")
    group.add_argument("--decay_lr_rate", type=float, default=0.0,
                       help="post cycle LR decay rate.")
    # 1Cycle momentum
    group.add_argument("--cycle_momentum", default=False,
                       action="store_true",
                       help="Enable 1Cycle momentum schedule.")
    group.add_argument("--cycle_min_mom", type=float, default=0.8,
                       help="1Cycle momentum lower bound.")
    group.add_argument("--cycle_max_mom", type=float, default=0.9,
                       help="1Cycle momentum upper bound.")
    group.add_argument("--decay_mom_rate", type=float, default=0.0,
                       help="post cycle momentum decay rate.")
    # Warmup LR
    group.add_argument("--warmup_min_lr", type=float, default=0,
                       help="WarmupLR minimum/initial LR value")
    group.add_argument("--warmup_max_lr", type=float, default=0.001,
                       help="WarmupLR maximum LR value.")
    group.add_argument("--warmup_num_steps", type=int, default=1000,
                       help="WarmupLR step count for LR warmup.")
    return parser


def parse_arguments():
    import argparse
    parser = argparse.ArgumentParser()
    parser = add_tuning_arguments(parser)
    return parser.parse_known_args()


_OVERRIDE_KEYS = {
    LR_RANGE_TEST: ("lr_range_test_min_lr", "lr_range_test_step_rate",
                    "lr_range_test_step_size", "lr_range_test_staircase"),
    ONE_CYCLE: ("cycle_first_step_size", "cycle_first_stair_count",
                "cycle_second_step_size", "cycle_second_stair_count",
                "decay_step_size", "cycle_min_lr", "cycle_max_lr",
                "decay_lr_rate", "cycle_momentum", "cycle_min_mom",
                "cycle_max_mom", "decay_mom_rate"),
    WARMUP_LR: ("warmup_min_lr", "warmup_max_lr", "warmup_num_steps"),
}


def _override(args, params, schedule):
    for k in _OVERRIDE_KEYS[schedule]:
        v = getattr(args, k, None)
        if v is not None:
            params[k] = v
    return params


def override_lr_range_test_params(args, params):
    return _override(args, params, LR_RANGE_TEST)


def override_1cycle_params(args, params):
    return _override(args, params, ONE_CYCLE)


def override_warmupLR_params(args, params):
    return _override(args, params, WARMUP_LR)


def override_params(args, params):
    override_lr_range_test_params(args, params)
    override_1cycle_params(args, params)
    return override_warmupLR_params(args, params)


def get_config_from_args(args):
    """(config, error): scheduler config dict from tuning CLI args
    (reference lr_schedules.py:238)."""
    if not hasattr(args, LR_SCHEDULE) or args.lr_schedule is None:
        return None, f"--{LR_SCHEDULE} not specified on command line"
    if args.lr_schedule not in VALID_LR_SCHEDULES:
        return None, f"{args.lr_schedule} is not supported LR schedule"
    config = {"type": args.lr_schedule, "params": {}}
    _override(args, config["params"], args.lr_schedule)
    return config, None


def get_lr_from_config(config):
    """(lr, error): the schedule's nominal peak/start LR
    (reference lr_schedules.py:259)."""
    if "type" not in config:
        return None, "LR schedule type not defined in config"
    if "params" not in config:
        return None, "LR schedule params not defined in config"
    lr_schedule, lr_params = config["type"], config["params"]
    if lr_schedule not in VALID_LR_SCHEDULES:
        return None, f"{lr_schedule} is not a valid LR schedule"
    if lr_schedule == LR_RANGE_TEST:
        return lr_params["lr_range_test_min_lr"], ""
    if lr_schedule == ONE_CYCLE:
        return lr_params["cycle_max_lr"], ""
    return lr_params["warmup_max_lr"], ""


class _Schedule:
    """Host-facing facade over the pure ``lr_at(step)``."""

    def __init__(self):
        self.last_batch_iteration = -1
        self._last_lr = None

    def lr_at(self, step):
        raise NotImplementedError

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = float(self.lr_at(last_batch_iteration))

    def get_lr(self):
        if self._last_lr is None:
            return [float(self.lr_at(0))]
        return [self._last_lr]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_Schedule):
    """Linear (or log) warmup from warmup_min_lr to warmup_max_lr over
    warmup_num_steps, then constant (reference lr_schedules.py:642)."""

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", last_batch_iteration: int = -1):
        super().__init__()
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(1, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps) \
            if self.warmup_num_steps > 1 else 1.0
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        step = float(max(step, 0))
        if self.warmup_type == "log":
            # reference lr_schedules.py:705: gamma = log(step + 1) / log(N)
            gamma = (1.0 if step + 1 >= self.warmup_num_steps
                     else self.inverse_log_warm_up * math.log(step + 1.0))
        else:
            gamma = min(step / self.warmup_num_steps, 1.0)
        return self.warmup_min_lr + \
            (self.warmup_max_lr - self.warmup_min_lr) * gamma


class LRRangeTest(_Schedule):
    """LR range test: ramp lr by lr_range_test_step_rate every
    lr_range_test_step_size steps, continuous or staircase
    (reference lr_schedules.py:298)."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = max(1, lr_range_test_step_size)
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        step = float(max(step, 0))
        if self.staircase:
            count = math.floor(step / self.step_size)
        else:
            count = step / self.step_size
        return self.min_lr * (1.0 + self.step_rate * count)


class OneCycle(_Schedule):
    """1-cycle policy: lr up then down, optional momentum counter-cycling
    and post-cycle decay (reference lr_schedules.py:398)."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 1e-4,
                 cycle_max_lr: float = 1e-3,
                 decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0,
                 cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.85,
                 cycle_max_mom: float = 0.99,
                 decay_mom_rate: float = 0.0,
                 last_batch_iteration: int = -1):
        super().__init__()
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = max(1, cycle_first_step_size)
        self.second_size = (cycle_second_step_size
                            if cycle_second_step_size is not None
                            else self.first_size)
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_second_stair_count
                                   if cycle_second_stair_count is not None
                                   else cycle_first_stair_count)
        self.decay_step_size = decay_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate
        self.total_size = self.first_size + self.second_size
        self.last_batch_iteration = last_batch_iteration

    @staticmethod
    def _stair(frac, stair_count):
        """Quantize a [0,1] phase fraction into stair_count flat steps
        (reference lr_schedules.py staircase interpolation)."""
        if stair_count and stair_count > 0:
            return math.floor(frac * stair_count) / stair_count
        return frac

    def _decay_steps(self, step):
        past = max(step - self.total_size, 0.0)
        return past / self.decay_step_size if self.decay_step_size > 0 \
            else past

    def lr_at(self, step):
        step = float(max(step, 0))
        if step > self.total_size:         # post-cycle decay
            return self.cycle_min_lr / (
                1.0 + self.decay_lr_rate * self._decay_steps(step))
        if step < self.first_size:         # position within the cycle
            up_frac = self._stair(_clip01(step / self.first_size),
                                  self.first_stair_count)
            return self.cycle_min_lr + \
                (self.cycle_max_lr - self.cycle_min_lr) * up_frac
        down_frac = self._stair(
            _clip01((step - self.first_size) / self.second_size),
            self.second_stair_count)
        return self.cycle_max_lr - \
            (self.cycle_max_lr - self.cycle_min_lr) * down_frac

    def mom_at(self, step):
        """Momentum counter-cycles the LR (reference lr_schedules.py:518)."""
        step = float(max(step, 0))
        if step > self.total_size:
            return self.cycle_max_mom * (
                1.0 + self.decay_mom_rate * self._decay_steps(step))
        if step < self.first_size:
            return self.cycle_max_mom - (
                self.cycle_max_mom - self.cycle_min_mom) * _clip01(
                    step / self.first_size)
        return self.cycle_min_mom + (
            self.cycle_max_mom - self.cycle_min_mom) * _clip01(
                (step - self.first_size) / self.second_size)


def _clip01(x):
    return min(max(x, 0.0), 1.0)


def build_lr_schedule(name: Optional[str], params: Optional[dict]):
    """Construct from JSON config (reference engine.py:402-417)."""
    if name is None:
        return None
    params = dict(params or {})
    params.pop("warmup_proportion", None)  # client-side extension, ignored
    if name == WARMUP_LR:
        return WarmupLR(**params)
    if name == LR_RANGE_TEST:
        return LRRangeTest(**params)
    if name == ONE_CYCLE:
        return OneCycle(**params)
    raise ValueError(
        f"Unknown scheduler {name}; valid: {VALID_LR_SCHEDULES}")
