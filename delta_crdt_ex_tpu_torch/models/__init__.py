"""Model classes of the port. The default engine is the bucket-binned
``BinnedAWLWWMap`` (exported as ``AWLWWMap``, as the package-level
export in :mod:`delta_crdt_ex_tpu_torch` and its ``api``); the hash
store's models sit beside it.

Every name resolves lazily: ``binned_map`` imports ``ops.binned``, which
imports ``models.binned``, so an eager import here would re-enter this
package mid-initialisation whenever ``ops.binned`` is loaded first.
"""

__all__ = [
    "AWLWWMap",
    "BinnedAWLWWMap",
    "BinnedStore",
    "HashAWLWWMap",
    "HashAWSet",
    "HashStore",
]

_LAZY = {
    "AWLWWMap": ("delta_crdt_ex_tpu_torch.models.binned_map", "BinnedAWLWWMap"),
    "BinnedAWLWWMap": ("delta_crdt_ex_tpu_torch.models.binned_map", "BinnedAWLWWMap"),
    "BinnedStore": ("delta_crdt_ex_tpu_torch.models.binned", "BinnedStore"),
    "HashAWLWWMap": ("delta_crdt_ex_tpu_torch.models.hash_store", "HashAWLWWMap"),
    "HashAWSet": ("delta_crdt_ex_tpu_torch.models.hash_store", "HashAWSet"),
    "HashStore": ("delta_crdt_ex_tpu_torch.models.hash_store", "HashStore"),
}


def __getattr__(name):
    import importlib

    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value
