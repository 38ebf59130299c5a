"""The replica runtime. ``Replica``, ``LocalTransport``, ``MemoryStorage``
and ``Storage`` resolve lazily, so that importing one runtime module does
not import the replica and every module it needs."""

__all__ = ["LocalTransport", "MemoryStorage", "Replica", "Storage"]

_LAZY = {
    "LocalTransport": "delta_crdt_ex_tpu_torch.runtime.transport",
    "MemoryStorage": "delta_crdt_ex_tpu_torch.runtime.storage",
    "Replica": "delta_crdt_ex_tpu_torch.runtime.replica",
    "Storage": "delta_crdt_ex_tpu_torch.runtime.storage",
}


def __getattr__(name):
    import importlib

    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
