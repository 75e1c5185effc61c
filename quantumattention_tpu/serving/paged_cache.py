"""Paged KV cache: fixed-size page pool + per-sequence page tables.

vLLM-style memory management for the serving engine (BASELINE.md decode
config: "FP8/int8 paged KV blocks + continuous batching").  One logical page
id addresses the same physical slot in every layer's pool, so the allocator
and page tables are shared across layers while each layer owns its page
arrays.

Device-side layout per layer (matching ops/paged.py):
  k_pages / v_pages:           (Hkv, num_pages, page_size, D)
  k_scale_pages / v_scale_pages (8-bit pages): fp32,
      (Hkv, num_pages, page_size)           for page_size <= 128,
      (Hkv, num_pages, page_size/128, 128)  for larger pages (the folded
      layout the page writes and the gather both read).

Host-side state (plain numpy — allocation is Python-scheduler work):
  free page list, page_tables (num_slots, max_pages_per_seq), lengths.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import quant
from ..utils import checks


def hash_pages(prompt: Sequence[int], page_size: int) -> List[bytes]:
    """Chained content hashes of a prompt's WHOLE pages.

    ``h[i]`` identifies the page holding tokens ``[i*ps, (i+1)*ps)`` AND
    everything before it (the chain makes a page's identity depend on its
    full prefix, so two prompts share page i only when they agree on all
    of ``[0, (i+1)*ps)``) — the vLLM automatic-prefix-caching scheme.
    Partial trailing pages are never hashed (never shared)."""
    out: List[bytes] = []
    h = b""
    for i in range(len(prompt) // page_size):
        chunk = np.asarray(
            prompt[i * page_size : (i + 1) * page_size], np.int32
        ).tobytes()
        h = hashlib.sha1(h + chunk).digest()
        out.append(h)
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LayerPages:
    k: jax.Array
    v: jax.Array
    k_scale: Optional[jax.Array] = None
    v_scale: Optional[jax.Array] = None


def init_layer_pages(
    num_kv_heads: int, num_pages: int, page_size: int, head_dim: int, dtype,
    int4: bool = False,
) -> LayerPages:
    """``int4=True`` packs two TOKENS per int8 byte along the page's token
    axis (split-halves within each page: token t -> low nibble of row t,
    token t + page_size/2 -> high nibble), so pages are
    (Hkv, P, page_size/2, head_dim).  Packing the token axis — not
    head_dim like the slot cache — keeps the head_dim minor dim intact
    for the page gather (ops/paged.py).  Scales stay per REAL token:
    (Hkv, P, page_size) fp32."""
    if int4:
        if dtype != jnp.int8:
            raise ValueError("int4 pages use an int8 container")
        if page_size % 2 != 0:
            raise ValueError("int4 pages need an even page_size")
        shape = (num_kv_heads, num_pages, page_size // 2, head_dim)
    else:
        shape = (num_kv_heads, num_pages, page_size, head_dim)
    pages = LayerPages(k=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype))
    if checks.is_8bit_dtype(dtype):
        pages.k_scale = jnp.ones(scale_shape(
            num_kv_heads, num_pages, page_size), jnp.float32)
        pages.v_scale = jnp.ones(scale_shape(
            num_kv_heads, num_pages, page_size), jnp.float32)
    return pages


def scale_shape(num_kv_heads: int, num_pages: int, page_size: int) -> tuple:
    """Scale-page array shape (module docstring: >128-token pages fold the
    token axis into (page_size/128, 128))."""
    if page_size > 128 and page_size % 128 == 0:
        return (num_kv_heads, num_pages, page_size // 128, 128)
    return (num_kv_heads, num_pages, page_size)


def scale_token_rows(scale: jax.Array) -> int:
    """Tokens per page covered by a scale array in either layout."""
    if scale.ndim == 4:
        return scale.shape[2] * scale.shape[3]
    return scale.shape[2]


@functools.partial(jax.jit, static_argnums=(2,))
def write_tokens(
    pages: LayerPages,
    page_ids: jax.Array,
    offset_in_first_page: int,
    k_new: jax.Array,
    v_new: jax.Array,
) -> LayerPages:
    """Write (Hkv, T, D) float tokens starting at the given page offset.

    ``page_ids``: (P,) int32 physical pages covering
    [offset_in_first_page, offset_in_first_page + T).  T and the offset are
    static (the engine pads chunks to page multiples), so this jits per
    (T, offset) bucket.

    MUST stay jitted: run eagerly, the chain of dynamic_update_slices
    triggers this environment's CPU-runtime buffer-aliasing corruption
    (the same class as the donation hazard documented in
    kv_cache.append) — page writes intermittently vanish and the paged
    engine becomes nondeterministic.  One compiled call keeps every
    intermediate buffer internal.
    """
    dtype = pages.k.dtype
    hkv, _, page_rows, head_dim = pages.k.shape
    # Token-packed int4 pages carry page_size/2 byte rows but per-REAL-token
    # scales; the scale extent recovers the true page size.
    int4 = (
        pages.k_scale is not None
        and scale_token_rows(pages.k_scale) == 2 * page_rows
    )
    page_size = scale_token_rows(pages.k_scale) if int4 else page_rows
    t = k_new.shape[1]
    # Cast INSIDE the jit: an eager astype at the call site is another
    # aliasing-hazard op on this CPU runtime (see the docstring).
    k_new = k_new.astype(jnp.float32)
    v_new = v_new.astype(jnp.float32)

    def quantize(x):
        if not checks.is_8bit_dtype(dtype):
            return x.astype(dtype), None
        if int4:
            return quant.quantize_int4_values(x, reduction_dim=-1)
        if dtype == jnp.int8:
            return quant.dynamically_quantize_int8(x, reduction_dim=-1)
        return quant.dynamically_quantize_fp8(x, reduction_dim=-1)

    kq, ks = quantize(k_new)
    vq, vs = quantize(v_new)

    k_pages, v_pages = pages.k, pages.v
    ksc, vsc = pages.k_scale, pages.v_scale

    def write_page(dst, values, page, pos, take, src):
        chunk = values[:, None, src : src + take]
        if not int4:
            return jax.lax.dynamic_update_slice(dst, chunk, (0, page, pos, 0))
        # Nibble-granular write: unpack the target page's token axis,
        # splice the new rows in, repack.  All inside this jit, so the
        # intermediate full-precision page never escapes (same aliasing
        # rationale as the docstring).
        cur = jax.lax.dynamic_slice(
            dst, (0, page, 0, 0), (hkv, 1, page_rows, head_dim)
        )
        full = quant.unpack_int4(cur, jnp.int8, axis=2)
        full = jax.lax.dynamic_update_slice(
            full, chunk.astype(jnp.int8), (0, 0, pos, 0)
        )
        return jax.lax.dynamic_update_slice(
            dst, quant.pack_int4(full, axis=2), (0, page, 0, 0)
        )

    pos = offset_in_first_page
    src = 0
    pi = 0
    while src < t:
        take = min(page_size - pos, t - src)
        page = page_ids[pi]
        k_pages = write_page(k_pages, kq, page, pos, take, src)
        v_pages = write_page(v_pages, vq, page, pos, take, src)
        if ks is not None:
            if ksc.ndim == 4:
                # Folded layout: the write must cover whole 128-token
                # sub-rows (the engine pads chunks to page multiples and
                # calls with offset 0, so this always holds).
                if pos % 128 or take % 128:
                    raise ValueError(
                        f"folded scale pages need 128-aligned writes "
                        f"(pos={pos}, take={take})"
                    )
                upd = (0, page, pos // 128, 0)
                ksc = jax.lax.dynamic_update_slice(
                    ksc,
                    ks[:, None, src : src + take].reshape(
                        ks.shape[0], 1, take // 128, 128
                    ),
                    upd,
                )
                vsc = jax.lax.dynamic_update_slice(
                    vsc,
                    vs[:, None, src : src + take].reshape(
                        vs.shape[0], 1, take // 128, 128
                    ),
                    upd,
                )
            else:
                ksc = jax.lax.dynamic_update_slice(
                    ksc, ks[:, None, src : src + take], (0, page, pos)
                )
                vsc = jax.lax.dynamic_update_slice(
                    vsc, vs[:, None, src : src + take], (0, page, pos)
                )
        src += take
        pos = 0
        pi += 1
    return LayerPages(k=k_pages, v=v_pages, k_scale=ksc, v_scale=vsc)


class PageAllocator:
    """Host-side free-list allocator + per-slot page tables, with optional
    automatic prefix caching (vLLM-style): whole prompt pages are
    content-addressed by chained hash (``hash_pages``), refcounted while
    any slot's table points at them, and parked in an LRU pool when idle —
    reusable by a later prompt with the same prefix, evictable when the
    free list runs dry.  Shared pages are append-safe without
    copy-on-write because the engine only ever writes a slot's OWN pages:
    prefill starts after the adopted prefix, and decode appends at
    positions past the prompt."""

    def __init__(self, num_pages: int, num_slots: int, pages_per_seq: int):
        self.num_pages = num_pages
        self.pages_per_seq = pages_per_seq
        self.free: List[int] = list(range(num_pages))
        # Entry 0 is a safe default (kernel requires valid indices).
        self.tables = np.zeros((num_slots, pages_per_seq), np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.allocated = np.zeros((num_slots,), np.int32)
        # Prefix cache: content hash -> page id, live refcounts, and the
        # idle (refcount-0) pages in LRU order.
        self.cache: Dict[bytes, int] = {}
        self.page_hash: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}
        self.idle: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict()
        )

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def evictable_pages(self) -> int:
        return len(self.idle)

    def pages_for(self, n_tokens: int, page_size: int) -> int:
        return -(-n_tokens // page_size)

    def can_fit(self, n_tokens: int, page_size: int) -> bool:
        return self.pages_for(n_tokens, page_size) <= (
            len(self.free) + len(self.idle)
        )

    def _take_free(self) -> int:
        if self.free:
            return self.free.pop()
        if self.idle:  # evict the least-recently-used cached prefix page
            page, _ = self.idle.popitem(last=False)
            del self.cache[self.page_hash.pop(page)]
            self.refs.pop(page, None)
            return page
        raise MemoryError("out of KV pages")

    def allocate(self, slot: int, n_tokens: int, page_size: int) -> np.ndarray:
        """Reserve pages so the slot can hold n_tokens total; returns the
        newly allocated page ids (possibly empty)."""
        have = int(self.allocated[slot])
        need = max(have, self.pages_for(n_tokens, page_size))
        if need > self.pages_per_seq:
            raise ValueError(
                f"{n_tokens} tokens need {need} pages > pages_per_seq "
                f"({self.pages_per_seq})"
            )
        new = []
        for i in range(have, need):
            page = self._take_free()
            self.tables[slot, i] = page
            new.append(page)
        self.allocated[slot] = need
        return np.asarray(new, np.int32)

    def release(self, slot: int) -> None:
        for i in range(int(self.allocated[slot])):
            page = int(self.tables[slot, i])
            if page in self.page_hash:
                self.refs[page] -= 1
                if self.refs[page] == 0:
                    self.idle[page] = None  # evictable, newest last
            else:
                self.free.append(page)
        self.tables[slot] = 0
        self.lengths[slot] = 0
        self.allocated[slot] = 0

    # -- prefix cache ------------------------------------------------------

    def match_prefix(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest cached run of ``hashes`` from the start; returns the
        page ids (does NOT take references — call ``adopt``)."""
        pages: List[int] = []
        for h in hashes:
            page = self.cache.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def adopt(self, slot: int, pages: Sequence[int]) -> None:
        """Point the slot's first ``len(pages)`` table entries at shared
        pages (refcounted).  Must run before ``allocate`` for the slot."""
        if int(self.allocated[slot]):
            raise ValueError("adopt() requires an empty slot")
        for i, page in enumerate(pages):
            self.tables[slot, i] = page
            self.refs[page] = self.refs.get(page, 0) + 1
            self.idle.pop(page, None)  # back in use
        self.allocated[slot] = len(pages)

    def register(self, slot: int, hashes: Sequence[bytes]) -> None:
        """Publish the slot's first ``len(hashes)`` OWN pages under their
        content hashes (first writer wins; already-shared/registered pages
        are skipped).  The slot keeps using them; they become reusable by
        later prompts and idle/evictable after every holder releases."""
        for i, h in enumerate(hashes):
            page = int(self.tables[slot, i])
            if page in self.page_hash:  # adopted or already registered
                continue
            if h in self.cache:  # same content published by another slot
                continue
            self.cache[h] = page
            self.page_hash[page] = h
            self.refs[page] = self.refs.get(page, 0) + 1

    # -- helpers ---------------------------------------------------------

    page_size_hint: int = 0  # set by the engine at construction
