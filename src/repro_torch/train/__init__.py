"""Training seams of the port: checkpointed, interruption-safe decision
forest training with bit-identical resume (``train.checkpoint``), and the
LM stack's train step and loop (``train.step``, ``train.loop``). The LM
symbols load lazily: importing ``repro_torch.train.checkpoint`` does not
pay for the model stack."""
_LAZY = {
    "TrainStepBundle": "repro_torch.train.step",
    "init_train_state": "repro_torch.train.step",
    "make_train_step": "repro_torch.train.step",
    "train_state_specs": "repro_torch.train.step",
    "LoopConfig": "repro_torch.train.loop",
    "train_loop": "repro_torch.train.loop",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_LAZY)
