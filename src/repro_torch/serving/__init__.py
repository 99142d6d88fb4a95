"""Serving of the port (mirrors ``repro.serving``): for forests the
padded-dispatch bundles, the micro-batcher, the fault harness, the
fault-tolerant ``ForestServer`` and its asyncio front end
``AsyncForestServer``; for the LM stack prefill and decode bundles and
``greedy_generate`` (``serving.decode``)."""

_LAZY = {
    "ServeBundle": "repro_torch.serving.decode",
    "make_decode_step": "repro_torch.serving.decode",
    "make_prefill": "repro_torch.serving.decode",
    "serve_state_specs": "repro_torch.serving.decode",
    "greedy_generate": "repro_torch.serving.decode",
    "ForestServeBundle": "repro_torch.serving.forest",
    "MicroBatcher": "repro_torch.serving.forest",
    "make_forest_server": "repro_torch.serving.forest",
    "FakeClock": "repro_torch.serving.faults",
    "FaultPlan": "repro_torch.serving.faults",
    "FaultyPredictor": "repro_torch.serving.faults",
    "AsyncForestServer": "repro_torch.serving.server",
    "CircuitBreaker": "repro_torch.serving.server",
    "ForestServer": "repro_torch.serving.server",
    "RequestFailed": "repro_torch.serving.server",
    "RequestShed": "repro_torch.serving.server",
    "RequestTimedOut": "repro_torch.serving.server",
    "RetryPolicy": "repro_torch.serving.server",
    "ServerMetrics": "repro_torch.serving.server",
}


def __getattr__(name):
    # lazy: the server pulls in the engines and torch only when asked for
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
