"""searchlite_tpu_torch: the PyTorch and CUDA port of searchlite_tpu.

The batched BM25 route runs on torch tensors, with a hand-written Hopper
kernel for the candidate-strip sort + combine + top-k
(``ops/strip_topk.py``, ``csrc/strip_topk.cu``). The JAX-free host modules
of ``searchlite_tpu`` (index, storage, analysis, query, native prep and
the numpy partitions) are shared, not copied. This package never imports
JAX.

    from searchlite_tpu_torch.api.reader import IndexReader
    reader = IndexReader(index, device="cuda")
"""
