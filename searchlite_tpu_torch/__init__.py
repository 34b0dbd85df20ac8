"""searchlite_tpu_torch: the PyTorch and CUDA port of searchlite_tpu.

Single-query ``search()`` (the dense compiled executor,
``ops/score.py``, and the sparse single routes) and the batched BM25
routes run on torch tensors, with hand-written Hopper kernels for the
candidate-strip core (``ops/strip_topk.py``, ``csrc/strip_topk.cu``) and
the fused dense score + mask + top-k (``ops/fused_topk.py``,
``csrc/fused_topk.cu``). The package keeps its own
copies of the host layers it needs (storage, index, analysis, query, the
native ingest and query prep, the numpy partitions) under the same paths
as in ``searchlite_tpu``; it imports neither JAX nor ``searchlite_tpu``.
Both packages read and write the same index directories.

    from searchlite_tpu_torch.index import Index
    reader = Index.open(options).reader()      # on the card
    # or: IndexReader(index), IndexReader(index, device="cpu")
    reader.search({"query": "rust systems", "limit": 10})
"""

__version__ = "0.1.0"


def _tune_numpy_allocator() -> None:
    """Disable numpy's MADV_HUGEPAGE on large allocations (opt back in
    with SEARCHLITE_NUMPY_HUGEPAGE=1). On virtualized hosts where hugepage
    faults are backed lazily by the hypervisor, first-touch of a fresh
    large array is far slower with the madvise; on bare metal it saves a
    few percent at most. Ingest, segment open and batch prep all
    allocate-and-fill large arrays."""
    import os
    import sys

    if sys.platform != "linux":
        return
    if os.environ.get("SEARCHLITE_NUMPY_HUGEPAGE") == "1":
        return
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:
        try:
            from numpy._core import multiarray as _ma
        except ImportError:  # numpy 1.x
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:  # noqa: BLE001 -- tuning only, never fatal
        pass


_tune_numpy_allocator()
