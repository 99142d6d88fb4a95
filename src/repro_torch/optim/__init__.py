from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
    make_optimizer,
    opt_slot_specs,
)
