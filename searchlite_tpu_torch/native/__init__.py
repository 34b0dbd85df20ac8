"""Native (C/C++) host accelerators: ingest, query prep, result lists,
and the single-core C++ baseline engine the bench compares against.

Compiles the sources at the repository root (``native/slt_ingest.cpp``,
``native/slt_results.c``, ``native/slt_cpu_engine.cpp``) on first use with g++/gcc into
``build/native/`` at the repository root (gitignored; each library is
keyed by a content hash of every native source, so an edited source never
loads a stale library) and binds them with ctypes. The native builder
handles the `default` tokenizer's ASCII subset at C++ speed; non-ASCII
values and non-default analyzers fall back to the exact Python path per
value, so output is identical either way. If no compiler is available
everything uses pure Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from searchlite_tpu_torch.index.postings import BLOCK, PostingsData

_LIB = None
_LIB_LOCK = threading.Lock()
_LIB_FAILED = False


def _source_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "native", "slt_ingest.cpp")


def _hashed_cache_path(stem: str) -> str:
    """Output path under the repository's ``build/native/``, keyed by the
    CONTENT hash of every native source file, so two checkouts of
    different sources never share a library."""
    import hashlib  # noqa: PLC0415

    src_dir = os.path.dirname(_source_path())
    h = hashlib.sha1()
    for f in sorted(os.listdir(src_dir)):
        if f.endswith((".cpp", ".h", ".c")):
            with open(os.path.join(src_dir, f), "rb") as fh:
                h.update(f.encode())
                h.update(fh.read())
    build_dir = os.path.join(os.path.dirname(src_dir), "build", "native")
    os.makedirs(build_dir, exist_ok=True)
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:12]}.so")


def _build_lib() -> str | None:
    src = _source_path()
    if not os.path.exists(src):
        return None
    out = _hashed_cache_path("slt_ingest")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
           src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    return out


def get_lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("SEARCHLITE_DISABLE_NATIVE"):
            _LIB_FAILED = True
            return None
        path = _build_lib()
        if path is None:
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _LIB_FAILED = True
            return None
        lib.slt_new.restype = ctypes.c_void_p
        lib.slt_new.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.slt_free.argtypes = [ctypes.c_void_p]
        lib.slt_add_token.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
        lib.slt_add_text.restype = ctypes.c_longlong
        lib.slt_add_text.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.slt_add_stopword.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.slt_add_text_unicode.restype = ctypes.c_longlong
        lib.slt_add_text_unicode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_uint32, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.slt_add_texts.restype = None
        lib.slt_add_texts.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.uint8),
            ctypes.c_longlong, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.uint8),
            np.ctypeslib.ndpointer(np.uint8),
            np.ctypeslib.ndpointer(np.uint8),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64)]
        lib.slt_stem.restype = ctypes.c_int
        lib.slt_stem.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.slt_finish.argtypes = [ctypes.c_void_p]
        for name in ("slt_n_terms", "slt_n_blocks", "slt_n_postings",
                     "slt_n_positions", "slt_terms_bytes"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        lib.slt_export.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32),
        ]
        if hasattr(lib, "slt_impacts"):
            # (guarded: a stale cached .so from an older source tree
            # lacks the symbol; callers hasattr-check and fall back)
            lib.slt_impacts.restype = ctypes.c_int64
            lib.slt_impacts.argtypes = [
                np.ctypeslib.ndpointer(np.int32),    # block_docs
                ctypes.c_int64,                      # n_rows
                np.ctypeslib.ndpointer(np.int32),    # row_field
                np.ctypeslib.ndpointer(np.float32),  # block_tfs
                np.ctypeslib.ndpointer(np.float32),  # doc_len [f, n1]
                ctypes.c_int64,                      # n1
                np.ctypeslib.ndpointer(np.float32),  # avgdl
                ctypes.c_double, ctypes.c_double,    # k1, b
                ctypes.c_int32,                      # n_docs
                np.ctypeslib.ndpointer(np.int32),    # bd_out
                np.ctypeslib.ndpointer(np.float32),  # bi_out
                np.ctypeslib.ndpointer(np.float32),  # block_max
                np.ctypeslib.ndpointer(np.int32),    # docs_flat
                np.ctypeslib.ndpointer(np.float32),  # impacts_flat
            ]
        lib.slt_qprep_new.restype = ctypes.c_void_p
        lib.slt_qprep_new.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64]
        lib.slt_qprep_stopword.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.slt_qprep_free.argtypes = [ctypes.c_void_p]
        lib.slt_qprep_batch.restype = ctypes.c_int64
        lib.slt_qprep_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
            ctypes.c_int32, np.ctypeslib.ndpointer(np.uint8),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64)]
        _LIB = lib
        return _LIB


_RESULTS_MOD = None
_RESULTS_FAILED = False


def get_results_mod():
    """Build + import the slt_results CPython extension (pairs-result
    materialization in C; native/slt_results.c). Returns the module or
    None — callers keep the pure-Python merge as fallback."""
    global _RESULTS_MOD, _RESULTS_FAILED
    if _RESULTS_MOD is not None or _RESULTS_FAILED:
        return _RESULTS_MOD
    with _LIB_LOCK:
        if _RESULTS_MOD is not None or _RESULTS_FAILED:
            return _RESULTS_MOD
        if os.environ.get("SEARCHLITE_DISABLE_NATIVE"):
            _RESULTS_FAILED = True
            return None
        src = os.path.join(os.path.dirname(_source_path()),
                           "slt_results.c")
        if not os.path.exists(src):
            _RESULTS_FAILED = True
            return None
        out = _hashed_cache_path("slt_results")
        try:
            if not os.path.exists(out):
                import sysconfig
                tmp = out + f".tmp{os.getpid()}"
                cmd = ["gcc", "-O2", "-shared", "-fPIC",
                       f"-I{sysconfig.get_paths()['include']}",
                       src, "-o", tmp]
                try:
                    subprocess.run(cmd, check=True, capture_output=True,
                                   timeout=120)
                except (subprocess.SubprocessError, FileNotFoundError):
                    cmd[0] = "g++"
                    subprocess.run(cmd, check=True, capture_output=True,
                                   timeout=120)
                os.replace(tmp, out)
            import importlib.util
            spec = importlib.util.spec_from_file_location(
                "slt_results", out)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _RESULTS_MOD = mod
        except (subprocess.SubprocessError, FileNotFoundError, OSError,
                ImportError):
            _RESULTS_FAILED = True
            return None
        return _RESULTS_MOD


def build_cpu_engine_lib() -> str | None:
    """Build (or reuse) the single-core C++ BM25/WAND/BMW engine
    (``native/slt_cpu_engine.cpp``), the same-run CPU baseline of
    ``tools/bench.py``, into ``build/native/``. Returns the library path,
    or None without a toolchain."""
    here = os.path.dirname(_source_path())
    src = os.path.join(here, "slt_cpu_engine.cpp")
    if not os.path.exists(src):
        return None
    out = _hashed_cache_path("slt_cpu_engine")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    return out


class CpuEngine:
    """ctypes wrapper over the C++ CPU baseline engine. Modes:
    "bm25" (TAAT brute), "wand", "bmw": the same exact top-k contract as
    the device paths (score desc, doc asc)."""

    MODES = {"bm25": 0, "wand": 1, "bmw": 2}

    def __init__(self, seg_reader, k1: float = 0.9, b: float = 0.4,
                 field: str | None = None):
        path = build_cpu_engine_lib()
        if path is None:
            raise RuntimeError("cpu engine unavailable (no toolchain)")
        lib = ctypes.CDLL(path)
        lib.slt_eng_new.restype = ctypes.c_void_p
        lib.slt_eng_new.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.float32),
            ctypes.c_double, ctypes.c_double, ctypes.c_double]
        lib.slt_eng_free.argtypes = [ctypes.c_void_p]
        lib.slt_eng_search_batch.restype = ctypes.c_int64
        lib.slt_eng_search_batch.argtypes = [
            ctypes.c_void_p, np.ctypeslib.ndpointer(np.int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32)]
        self._lib = lib
        postings = seg_reader.postings
        term_df = postings.term_df.astype(np.int64)
        self.base = np.concatenate(
            [[0], np.cumsum(term_df)]).astype(np.int64)
        flat_mask = postings.block_docs.reshape(-1) >= 0
        docs_flat = np.ascontiguousarray(
            postings.block_docs.reshape(-1)[flat_mask].astype(np.int32))
        tfs_flat = np.ascontiguousarray(
            postings.block_tfs.reshape(-1)[flat_mask].astype(np.float32))
        n_docs = seg_reader.doc_count
        if field is None:
            fields = [n[len("_len:"):] for n in seg_reader.fast.columns
                      if n.startswith("_len:")]
            field = fields[0] if fields else None
        doc_len = np.zeros(n_docs, dtype=np.float32)
        avgdl = 0.0
        if field is not None:
            col = seg_reader.fast.column(f"_len:{field}")
            if col is not None and len(col.values):
                doc_len[col.row_ids] = col.values.astype(np.float32)
            avgdl = float(seg_reader.avg_field_length(field))
        self.terms = seg_reader.terms
        self._handle = lib.slt_eng_new(
            n_docs, len(term_df), self.base, docs_flat, tfs_flat,
            doc_len, avgdl, k1, b)
        if not self._handle:
            raise RuntimeError("engine construction failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.slt_eng_free(handle)
            self._handle = None

    def tid(self, key: str) -> int:
        t = self.terms.get(key)
        return -1 if t is None else int(t)

    def search_batch(self, qtids: np.ndarray, k: int,
                     mode: str = "bmw"):
        """qtids: [n_queries, terms_per_query] int32 (-1 = missing).
        Returns (ids [n,k] int32 with -1 pads, scores [n,k] f32)."""
        qtids = np.ascontiguousarray(qtids, dtype=np.int32)
        nq, tpq = qtids.shape
        out_ids = np.empty((nq, k), dtype=np.int32)
        out_scores = np.empty((nq, k), dtype=np.float32)
        self._lib.slt_eng_search_batch(
            self._handle, qtids.reshape(-1), nq, tpq, k,
            self.MODES[mode], out_ids.reshape(-1),
            out_scores.reshape(-1))
        return out_ids, out_scores


class NativeQueryPrep:
    """Native batched query prep over one segment's terms dictionary:
    tokenizes plain term queries through the C++ analyzer chain (same
    tokens as ingest by construction), resolves term ids, and returns
    the per-query (slot-tid, count) CSR that build_impact_batch
    assembles its tables from. One handle per (segment, stopword-set);
    term-id lookups are memoized inside the handle across batches."""

    def __init__(self, terms: list[str],
                 stopwords: frozenset[str] | None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        encoded = [t.encode() for t in terms]
        offs = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offs[1:])
        blob = b"".join(encoded)
        self._handle = lib.slt_qprep_new(
            blob, len(blob), offs, len(encoded))
        if stopwords:
            for w in stopwords:
                wb = w.encode()
                lib.slt_qprep_stopword(self._handle, wb, len(wb))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.slt_qprep_free(handle)
            self._handle = None

    def prep_batch(self, queries: list[str], field_prefixes: list[str],
                   field_flags: np.ndarray):
        """Returns (qs_start i64[Q+1], qs_slot i32[E], qs_cnt i32[E],
        slot_tids i64[S]) or None when a query needs the Python path."""
        try:
            qenc = [q.encode() for q in queries]
        except UnicodeEncodeError:
            return None
        q_off = np.zeros(len(qenc) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in qenc], out=q_off[1:])
        qblob = b"".join(qenc)
        fenc = [f.encode() for f in field_prefixes]
        f_off = np.zeros(len(fenc) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in fenc], out=f_off[1:])
        fblob = b"".join(fenc)
        cap = (len(qblob) // 2 + len(qenc) + 16) * max(len(fenc), 1)
        qs_start = np.zeros(len(qenc) + 1, dtype=np.int64)
        qs_slot = np.empty(cap, dtype=np.int32)
        qs_cnt = np.empty(cap, dtype=np.int32)
        slot_tids = np.empty(cap, dtype=np.int64)
        counts = np.zeros(2, dtype=np.int64)
        rc = self._lib.slt_qprep_batch(
            self._handle, qblob, q_off, len(qenc), fblob, f_off,
            len(fenc), field_flags, qs_start, qs_slot, qs_cnt, cap,
            slot_tids, counts)
        if rc != 0:
            return None
        n_e, n_s = int(counts[0]), int(counts[1])
        return (qs_start, qs_slot[:n_e], qs_cnt[:n_e], slot_tids[:n_s])


class NativeIndexBuilder:
    """Drop-in replacement for InvertedIndexBuilder backed by C++."""

    def __init__(self, enable_positions: bool = True):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.enable_positions = enable_positions
        # term-table shard / thread count for bulk adds: auto (<=0) uses
        # hardware_concurrency capped at 8; output is deterministic for
        # any value (terms are globally sorted at build)
        n_threads = int(os.environ.get("SEARCHLITE_INGEST_THREADS", 0))
        self._handle = self._lib.slt_new(
            1 if enable_positions else 0, n_threads)
        self._count = 0
        self._stopwords: frozenset | None = None

    def register_stopwords(self, words: frozenset) -> bool:
        """Register the builder's (single) stopword set. Returns False if
        a DIFFERENT set is already registered (caller must fall back)."""
        if self._stopwords is not None:
            return self._stopwords == words
        self._stopwords = frozenset(words)
        for word in self._stopwords:
            data = word.encode()
            self._lib.slt_add_stopword(self._handle, data, len(data))
        return True

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and self._lib is not None:
            self._lib.slt_free(handle)
            self._handle = None

    def add_term(self, term: str, doc: int, position: int,
                 with_positions: bool = True) -> None:
        data = term.encode()
        self._lib.slt_add_token(self._handle, data, len(data), doc,
                                position, 1 if with_positions else 0)
        self._count += 1

    def add_text(self, field: str, doc: int, text: str,
                 position_offset: int, use_stopwords: bool = False,
                 use_stem: bool = False, tokenizer: str = "default"):
        """Tokenize+add one text value natively.

        tokenizer="default": the ASCII fast path (optionally through
        the English stopword/stemmer chain); returns None when the
        value contains non-ASCII bytes (caller falls back per value).
        tokenizer="unicode": the full NFKC + UAX#29 + lowercase chain
        (native/slt_unicode.h), any input.

        Returns (token_count, max_position)."""
        prefix = f"{field}:".encode()
        raw = text.encode()
        out_max = ctypes.c_uint32(0)
        if tokenizer == "unicode":
            count = self._lib.slt_add_text_unicode(
                self._handle, prefix, len(prefix), doc, raw, len(raw),
                position_offset, 1 if use_stopwords else 0,
                ctypes.byref(out_max))
        else:
            if not text.isascii():
                return None
            count = self._lib.slt_add_text(
                self._handle, prefix, len(prefix), doc, raw, len(raw),
                position_offset, 1 if use_stopwords else 0,
                1 if use_stem else 0, ctypes.byref(out_max))
        if count < 0:
            return None
        max_pos = None if out_max.value == 0xFFFFFFFF else int(out_max.value)
        return int(count), max_pos

    def add_texts(self, texts_blob: bytes, text_off: np.ndarray,
                  doc_ords: np.ndarray, field_ids: np.ndarray,
                  new_group: np.ndarray, prefixes_blob: bytes,
                  prefix_off: np.ndarray, f_stop: np.ndarray,
                  f_stem: np.ndarray, f_unicode: np.ndarray
                  ) -> np.ndarray:
        """Bulk tokenize+add (one C call for thousands of values; the
        per-call ctypes boundary costs ~30us). See slt_add_texts in
        native/slt_ingest.cpp for the item/group contract. Returns the
        per-item surviving token counts."""
        n = len(doc_ords)
        out_counts = np.empty(n, dtype=np.int64)
        self._lib.slt_add_texts(
            self._handle, texts_blob, text_off, doc_ords, field_ids,
            new_group, n, prefixes_blob, prefix_off, f_stop, f_stem,
            f_unicode, len(f_stop), out_counts)
        self._count += int(out_counts.sum())
        return out_counts

    def build(self) -> PostingsData:
        lib = self._lib
        lib.slt_finish(self._handle)
        n_terms = lib.slt_n_terms(self._handle)
        n_blocks = lib.slt_n_blocks(self._handle)
        n_postings = lib.slt_n_postings(self._handle)
        n_positions = lib.slt_n_positions(self._handle)
        terms_bytes = lib.slt_terms_bytes(self._handle)

        terms_buf = ctypes.create_string_buffer(max(int(terms_bytes), 1))
        block_docs = np.empty((max(n_blocks, 0), BLOCK), dtype=np.int32)
        block_tfs = np.empty((max(n_blocks, 0), BLOCK), dtype=np.float32)
        block_term = np.empty(max(n_blocks, 0), dtype=np.int32)
        term_block_start = np.empty(max(n_terms, 0), dtype=np.int32)
        term_block_count = np.empty(max(n_terms, 0), dtype=np.int32)
        term_df = np.empty(max(n_terms, 0), dtype=np.int32)
        term_max_tf = np.empty(max(n_terms, 0), dtype=np.float32)
        block_max_tf = np.empty(max(n_blocks, 0), dtype=np.float32)
        block_last_doc = np.empty(max(n_blocks, 0), dtype=np.int32)
        pos_offsets = np.zeros(int(n_postings) + 1, dtype=np.int64)
        pos_values = np.empty(max(int(n_positions), 1), dtype=np.int32)

        if n_terms:
            lib.slt_export(
                self._handle, terms_buf,
                block_docs.reshape(-1), block_tfs.reshape(-1), block_term,
                term_block_start, term_block_count, term_df, term_max_tf,
                block_max_tf, block_last_doc, pos_offsets, pos_values)

        terms: list[str] = []
        raw = terms_buf.raw[:int(terms_bytes)]
        cursor = 0
        for _ in range(int(n_terms)):
            length = int.from_bytes(raw[cursor:cursor + 4], "little")
            cursor += 4
            terms.append(raw[cursor:cursor + length].decode())
            cursor += length

        return PostingsData(
            terms=terms,
            block_docs=block_docs,
            block_tfs=block_tfs,
            block_term=block_term,
            term_block_start=term_block_start,
            term_block_count=term_block_count,
            term_df=term_df,
            term_max_tf=term_max_tf,
            block_max_tf=block_max_tf,
            block_last_doc=block_last_doc,
            pos_values=pos_values[:int(n_positions)],
            pos_offsets=pos_offsets,
            has_positions=self.enable_positions,
        )
