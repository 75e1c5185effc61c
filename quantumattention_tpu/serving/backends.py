"""Cache backends for the continuous-batching engine.

The reference stops at the kernel boundary (SURVEY.md §0 — no KV cache,
no serving); this module is the storage half of this build's serving
extension.  ``serving/engine.Engine`` does scheduling only (queues,
admission order, sampling, emission); everything that touches cache
STATE — reservation, appends, attention, bursts, speculative
verification, release — lives behind one of two interchangeable
backends:

  * ``SlotsBackend`` — contiguous per-slot rows (num_slots, Hkv, max_len,
    D), the fast path: burst decode scans entirely on device and the
    ragged decode kernel (ops/decode.py) streams each slot's valid prefix.
  * ``PagedBackend``  — vLLM-style page pool + per-slot page tables
    (serving/paged_cache.py) with refcounted prefix caching; attention is
    the async-DMA paged kernel (ops/paged.py).

Both backends implement the same protocol (duck-typed; the engine holds
exactly one):

  check_submit(reservation)            raise if it could NEVER fit
  try_admit(req, slot, reservation)    reserve; None = backpressure,
                                       else prefix-matched token count
  register_prefix(req)                 publish prompt pages (paged only)
  write_prefill_batch(kv, slots, n_valid, padded)
  prefill_chunk(params, tokens, req, off, tc) -> last logits
  decode(params, tokens, active_mask, active_slots) -> logits
  burst(params, tokens, active, remaining, eos, key, n, sp, want_lp)
                                       -> packed trace array
  verify(params, cand, positions, active_mask) -> (T+1)-token logits
  rollback(rollback_mask, new_lengths) shrink lengths after speculation
  host_lengths() -> np.ndarray         current per-slot valid lengths
  release(slot)                        return the slot's storage
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models import llama
from ..ops import quant
from ..ops.decode import decode_attention
from ..utils.shapes import round_up
from . import kv_cache as kvc
from .sampling import SamplingParams, sample, sample_with_logprob


def window_of(cfg) -> Optional[tuple]:
    """HF convention: sliding_window=w attends to exactly w keys including
    self, i.e. left extent w-1 (models/llama._attend)."""
    return (cfg.window - 1, 0) if cfg.window is not None else None


def _donate_args(*idx) -> tuple:
    """Cache donation is a device-memory optimization only: the CPU runtime
    corrupts retained aliases of donated buffers (see kv_cache.append's
    note), so on CPU (the test runtime) donation is disabled outright."""
    return idx if jax.default_backend() != "cpu" else ()


def _chunk_prefix_attend(
    q, k_new, v_new, ck, cv, ks, vs, slot, off, *, head_dim, window
):
    """Cache-prefix + chunk fused attention for one slot (B == 1).

    Gathers the slot's first ``off`` cached tokens (dequantized;
    packed-int4 containers are detected by the value minor dim), concats
    the chunk's post-RoPE K/V, and runs the causal fused kernel with
    ``q_offset = off``.  Pure head-local math, so it is also the body
    ``serving/tp.chunk_attention_tp`` shard-maps over the KV-head axis.
    """
    from ..ops.flash import flash_attention

    if off > 0:
        hkv = ck.shape[1]

        def prefix(values, scales):
            dc = values.shape[-1]  # head_dim, or head_dim/2 packed
            p = jax.lax.dynamic_slice(
                values, (slot, 0, 0, 0), (1, hkv, off, dc)
            )
            if dc * 2 == head_dim:  # packed int4 (kv_int4=True)
                p = quant.unpack_int4(p, jnp.float32)
            else:
                p = p.astype(jnp.float32)
            if scales is not None:
                s = jax.lax.dynamic_slice(scales, (slot, 0, 0), (1, hkv, off))
                p = p * s[..., None]
            return p.astype(jnp.bfloat16)

        k_all = jnp.concatenate(
            [prefix(ck, ks), k_new.astype(jnp.bfloat16)], axis=2
        )
        v_all = jnp.concatenate(
            [prefix(cv, vs), v_new.astype(jnp.bfloat16)], axis=2
        )
    else:
        k_all = k_new
        v_all = v_new
    return flash_attention(
        q, k_all, v_all, is_causal=True, q_offset=jnp.int32(off),
        window=window,
    )


class SlotsBackend:
    """Contiguous slot cache: one (Hkv, max_len, D) row region per slot.

    Owns the per-layer ``kv_cache.KVCache`` list and every jitted device
    function that reads or writes it.  Supports single-chip serving and
    tensor-parallel serving (``mesh``: Megatron-sharded params outside,
    KV-head-sharded caches + shard_mapped kernels here — serving/tp.py).
    """

    name = "slots"

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        *,
        num_slots: int,
        max_len: int,
        cache_dtype,
        kv_int4: bool = False,
        decode_block_kv: Optional[int] = None,
        mesh=None,
        tp_axis: str = "tp",
    ) -> None:
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.kv_int4 = kv_int4
        self.decode_block_kv = decode_block_kv
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.caches = [
            kvc.init_cache(
                num_slots, cfg.num_kv_heads, max_len, cfg.head_dim,
                cache_dtype, int4=kv_int4,
            )
            for _ in range(cfg.num_layers)
        ]
        if mesh is not None:
            from . import tp as tp_lib

            self.caches = [
                tp_lib.shard_cache(c, mesh, tp_axis) for c in self.caches
            ]
        self._decode_jit = jax.jit(
            self._decode_step_impl, donate_argnums=_donate_args(1)
        )
        self._verify_jit = jax.jit(
            self._verify_impl, donate_argnums=_donate_args(1)
        )
        self._burst_jits = {}

    # -- admission ---------------------------------------------------------

    def check_submit(self, reservation: int) -> None:
        pass  # slot rows are pre-sized to max_len; submit() bounds-checks

    def try_admit(self, req, slot: int, reservation: int) -> Optional[int]:
        return 0  # storage pre-exists; no reservation, no prefix reuse

    def register_prefix(self, req) -> None:
        pass

    def can_speculate(self, active_slots, t_width: int) -> bool:
        return True  # slot rows are pre-sized to max_len

    # -- prefill -----------------------------------------------------------

    def write_prefill_batch(
        self, kv, slots: Sequence[int], n_valid: Sequence[int], padded: int
    ) -> None:
        """Scatter a batched prefill's per-layer K/V into the slots: all
        layers' cache appends go in ONE jitted dispatch (a per-layer loop
        is num_layers host dispatches per prefill round)."""
        slot_arr = jnp.asarray(list(slots), jnp.int32)
        zeros = jnp.zeros((len(slots),), jnp.int32)
        nvals = jnp.asarray(list(n_valid), jnp.int32)
        if not hasattr(self, "_append_all_jit"):

            def _append_all(caches, kv, slots, offs, nv):
                return [
                    kvc.append(
                        c, slots, kl.astype(jnp.float32),
                        vl.astype(jnp.float32), offs, nv,
                    )
                    for c, (kl, vl) in zip(caches, kv)
                ]

            self._append_all_jit = jax.jit(
                _append_all, donate_argnums=_donate_args(0)
            )
        self.caches = self._append_all_jit(
            self.caches, kv, slot_arr, zeros, nvals
        )

    def prefill_and_write(
        self, prefill_fn, params, tokens, last_pos,
        slots: Sequence[int], n_valid: Sequence[int], padded: int,
    ):
        """Whole-prompt prefill forward AND all layers' cache appends in
        ONE jitted dispatch (VERDICT r3 item 6: the separate append
        dispatch was ~20%% of the engine's prefill gap).  Returns the
        last-position logits; the caches update internally."""
        if not hasattr(self, "_pw_jit"):

            def _impl(params, caches, tokens, last_pos, slot_arr, nvals):
                logits, kv = prefill_fn(params, tokens, last_pos=last_pos)
                zeros = jnp.zeros_like(nvals)
                caches = [
                    kvc.append(
                        c, slot_arr, kl.astype(jnp.float32),
                        vl.astype(jnp.float32), zeros, nvals,
                    )
                    for c, (kl, vl) in zip(caches, kv)
                ]
                return caches, logits

            self._pw_jit = jax.jit(_impl, donate_argnums=_donate_args(1))
        self.caches, logits = self._pw_jit(
            params, self.caches, tokens,
            jnp.asarray(list(last_pos), jnp.int32),
            jnp.asarray(list(slots), jnp.int32),
            jnp.asarray(list(n_valid), jnp.int32),
        )
        return logits

    def _prefill_chunk_impl(self, params, caches, chunk_tokens, slot, off, tc):
        """Jitted (off static): one prefill chunk attending to cache prefix
        + itself, then appended to the cache (mixed prefill/decode building
        block — BASELINE config 4).  Under a mesh the attention runs
        shard-mapped on the KV-head axis (serving/tp.chunk_attention_tp)."""
        cfg = self.cfg
        width = chunk_tokens.shape[1]  # padded chunk width; tc <= width valid
        positions = off + jnp.arange(width, dtype=jnp.int32)
        recorded = {}

        def attend(idx, q, k_new, v_new):
            recorded[idx] = (k_new, v_new)
            c = caches[idx]
            if self.mesh is not None:
                from . import tp as tp_lib

                return tp_lib.chunk_attention_tp(
                    q, k_new, v_new, c, slot, off,
                    mesh=self.mesh, axis=self.tp_axis,
                    head_dim=cfg.head_dim, window=window_of(cfg),
                )
            return _chunk_prefix_attend(
                q, k_new, v_new, c.k, c.v, c.k_scale, c.v_scale, slot, off,
                head_dim=cfg.head_dim, window=window_of(cfg),
            )

        logits = llama.forward_chunk(params, chunk_tokens, positions, cfg, attend)
        slot_arr = slot[None]
        off_arr = jnp.full((1,), off, jnp.int32)
        nval_arr = jnp.reshape(tc, (1,)).astype(jnp.int32)
        for li in range(cfg.num_layers):
            k_l, v_l = recorded[li]
            # Full-width writes (tc stays traced -> one compile per chunk
            # offset, max_len/chunk total).  Alignment is guaranteed by the
            # max_len % prefill_chunk check at construction, so the write
            # can never run past the cache; rows beyond tc hold garbage but
            # lengths (off + tc) masks them and the next chunk overwrites.
            caches[li] = kvc.append(
                caches[li], slot_arr, k_l.astype(jnp.float32),
                v_l.astype(jnp.float32), off_arr, nval_arr,
            )
        return caches, logits

    def prefill_chunk(self, params, tokens, req, off: int, tc: int):
        if not hasattr(self, "_chunk_jit"):
            self._chunk_jit = jax.jit(
                self._prefill_chunk_impl, static_argnames=("off",)
            )
        self.caches, logits = self._chunk_jit(
            params, self.caches, tokens, jnp.int32(req.slot),
            off=off, tc=jnp.int32(tc),
        )
        return logits

    # -- decode ------------------------------------------------------------

    def _decode_step_impl(self, params, caches, tokens, active_mask):
        """Jitted: one decode step over all slots.

        Appends the current tokens' K/V, runs fused decode attention per
        layer, returns (new_caches, logits)."""
        cfg = self.cfg
        positions = caches[0].lengths  # pre-append lengths == positions

        def attend(idx, q, k_new, v_new):
            cache = caches[idx]
            slot_ids = jnp.arange(self.num_slots, dtype=jnp.int32)
            # Only bump lengths for active slots (inactive write at pos 0
            # with n_valid 0 — harmless, masked out by length).
            nval = active_mask.astype(jnp.int32)
            caches[idx] = kvc.append(
                cache,
                slot_ids,
                k_new[:, :, None, :].astype(jnp.float32),
                v_new[:, :, None, :].astype(jnp.float32),
                positions,
                nval,
            )
            c = caches[idx]
            if self.mesh is not None:
                from . import tp as tp_lib

                return tp_lib.decode_attention_tp(
                    q.astype(jnp.bfloat16),
                    c.k, c.v, c.lengths,
                    mesh=self.mesh, axis=self.tp_axis,
                    k_scale=c.k_scale, v_scale=c.v_scale,
                    block_kv=self.decode_block_kv,
                    window=window_of(cfg),
                )
            return decode_attention(
                q.astype(jnp.bfloat16),
                c.k,
                c.v,
                c.lengths,
                k_scale=c.k_scale,
                v_scale=c.v_scale,
                block_kv=self.decode_block_kv,
                window=window_of(cfg),
            )

        logits = llama.forward_decode(params, tokens, positions, cfg, attend)
        return caches, logits

    def decode(self, params, tokens, active_mask, active_slots):
        self.caches, logits = self._decode_jit(
            params, self.caches, jnp.asarray(tokens), jnp.asarray(active_mask)
        )
        return logits

    def _burst_impl(
        self, params, caches, tokens, active, remaining, eos_ids, key,
        *, n_steps: int, sp: SamplingParams, want_lp: bool = False,
    ):
        """Jitted: ``n_steps`` decode steps in one ``lax.scan``.  Sampling,
        EOS detection, and per-slot new-token budgets all run on device;
        the host gets back the token and emitted-mask traces (plus a
        logprob trace when ``want_lp``) — one dispatch per burst instead
        of per token."""

        def one(carry, _):
            caches, tokens, active, remaining, key = carry
            caches, logits = self._decode_step_impl(
                params, caches, tokens, active
            )
            key, sub = jax.random.split(key)
            skey = None if sp.temperature == 0.0 else sub
            if want_lp:
                nxt, lp = sample_with_logprob(logits, sp, skey)
            else:
                nxt = sample(logits, sp, skey)
                lp = jnp.zeros(nxt.shape, jnp.float32)
            emitted = active
            nxt = jnp.where(active, nxt, tokens)
            remaining = remaining - active.astype(jnp.int32)
            hit_eos = jnp.logical_and(nxt == eos_ids, eos_ids >= 0)
            active = jnp.logical_and(
                active, jnp.logical_and(~hit_eos, remaining > 0)
            )
            return (caches, nxt, active, remaining, key), (nxt, emitted, lp)

        (caches, *_), (toks, emits, lps) = jax.lax.scan(
            one, (caches, tokens, active, remaining, key), None,
            length=n_steps,
        )
        # ONE fetchable array: the token and emitted-mask (and logprob)
        # traces ship together in a single device-to-host copy.  Token ids
        # round-trip exactly through float32 (vocab < 2^24).
        if want_lp:
            packed = jnp.stack(
                [toks.astype(jnp.float32), emits.astype(jnp.float32), lps]
            )
        else:
            packed = jnp.stack([toks, emits.astype(jnp.int32)])
        return caches, packed

    def burst(
        self, params, tokens, active, remaining, eos_ids, key,
        n_steps: int, sp: SamplingParams, want_lp: bool,
        host_active=None,
    ) -> np.ndarray:
        del host_active  # protocol parity; slots need no host mask
        jitted = self._burst_jits.get((n_steps, sp, want_lp))
        if jitted is None:
            jitted = jax.jit(
                functools.partial(
                    self._burst_impl, n_steps=n_steps, sp=sp, want_lp=want_lp
                ),
                donate_argnums=_donate_args(1),
            )
            self._burst_jits[(n_steps, sp, want_lp)] = jitted
        self.caches, packed = jitted(
            params, self.caches, jnp.asarray(tokens), jnp.asarray(active),
            jnp.asarray(remaining), jnp.asarray(eos_ids), key,
        )
        return np.asarray(packed)  # one device-to-host copy per burst

    # -- speculative decoding ------------------------------------------------

    def _verify_impl(self, params, caches, tokens, positions, active_mask):
        """Jitted: multi-token target verification (speculative decoding).

        Appends the T candidate tokens to every active slot's cache, then
        computes logits for ALL T positions in ONE forward — this parallel
        pass is where speculative decoding's speedup comes from (the
        target touches its KV stream once per round instead of once per
        token).  Attention is the fused decode kernel's multi-query mode
        (4-D q: the kernel's M dim packs (group, token) pairs and masks
        each token's intra-chunk causality per row — no cache
        dequantization pass).

        Rollback of rejected tokens is just a lengths reset afterwards:
        the ragged-cache contract says rows beyond ``lengths`` are garbage
        and every append overwrites from its offset.
        """
        cfg = self.cfg
        t_width = tokens.shape[1]
        pos2d = positions[:, None] + jnp.arange(t_width, dtype=jnp.int32)

        def attend(idx, q, k_new, v_new):
            cache = caches[idx]
            slot_ids = jnp.arange(self.num_slots, dtype=jnp.int32)
            nval = active_mask.astype(jnp.int32) * t_width
            caches[idx] = kvc.append(
                cache, slot_ids,
                k_new.astype(jnp.float32), v_new.astype(jnp.float32),
                positions, nval,
            )
            c = caches[idx]
            return decode_attention(
                q.astype(jnp.bfloat16), c.k, c.v, c.lengths,
                k_scale=c.k_scale, v_scale=c.v_scale,
                block_kv=self.decode_block_kv,
                window=window_of(cfg),
            )

        logits = llama.forward_chunk(params, tokens, pos2d, cfg, attend)
        return caches, logits

    def verify(self, params, cand, positions, active_mask):
        self.caches, logits = self._verify_jit(
            params, self.caches, cand, jnp.asarray(positions),
            jnp.asarray(active_mask),
        )
        return logits

    def rollback(self, rollback_mask, new_lengths) -> None:
        import dataclasses

        rb = jnp.asarray(rollback_mask)
        nl = jnp.asarray(new_lengths)
        for li in range(self.cfg.num_layers):
            self.caches[li] = dataclasses.replace(
                self.caches[li],
                lengths=jnp.where(rb, nl, self.caches[li].lengths),
            )

    # -- bookkeeping ---------------------------------------------------------

    def host_lengths(self) -> np.ndarray:
        return np.asarray(self.caches[0].lengths)

    def release(self, slot: int) -> None:
        """Return the slot's rows (lengths 0); all layers' slot-frees go in
        ONE jitted dispatch — a per-layer loop is num_layers host
        dispatches per finished request."""
        if not hasattr(self, "_free_all_jit"):
            self._free_all_jit = jax.jit(
                lambda caches, s: [kvc.free_slots(c, s) for c in caches]
            )
        self.caches = self._free_all_jit(
            self.caches, jnp.array([slot], jnp.int32)
        )


class PagedBackend:
    """vLLM-style paged cache: global page pool + per-slot page tables.

    Owns the per-layer ``LayerPages``, the host-side ``PageAllocator``
    (free list, tables, refcounted prefix cache), and the jitted paged
    decode/burst/verify paths built on ``ops/paged.paged_decode_attention``.

    Admission makes a FULL reservation (prompt padding AND max_new_tokens)
    before a request leaves the waiting queue — so neither prefill nor any
    later decode/burst/verify step can run out of pages mid-stream, and
    the burst scan needs no in-flight page-table growth.
    """

    name = "paged"

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        *,
        num_slots: int,
        max_len: int,
        cache_dtype,
        kv_int4: bool = False,
        page_size: int = 128,
        num_pages: Optional[int] = None,
        decode_block_kv: Optional[int] = None,
        prefix_cache: bool = False,
    ) -> None:
        from . import paged_cache as pgc

        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.kv_int4 = kv_int4
        self.page_size = page_size
        self.decode_block_kv = decode_block_kv
        self.prefix_cache = prefix_cache
        self._pgc = pgc
        pages_per_seq = -(-max_len // page_size)
        if num_pages is None:
            # Default pool: enough for every slot at max_len (same
            # capacity as the slot backend; shrink for oversubscription).
            num_pages = num_slots * pages_per_seq + 1
        # One PHYSICAL page beyond the allocator's pool: the decode write
        # is a single batched scatter (not a per-slot loop), and inactive
        # slots' lanes need a destination that can never alias a live
        # sequence — page id ``num_pages`` is never allocated, so garbage
        # rows land there.
        self._trash_page = num_pages
        self.pages = [
            pgc.init_layer_pages(
                cfg.num_kv_heads, num_pages + 1, page_size, cfg.head_dim,
                cache_dtype, int4=kv_int4,
            )
            for _ in range(cfg.num_layers)
        ]
        self.alloc = pgc.PageAllocator(num_pages, num_slots, pages_per_seq)
        self.alloc.page_size_hint = page_size
        self._decode_jit = jax.jit(
            self._decode_step_impl, donate_argnums=_donate_args(1)
        )
        self._verify_jit = jax.jit(
            self._verify_impl, donate_argnums=_donate_args(1)
        )
        self._burst_jits = {}

    # -- admission ---------------------------------------------------------

    def check_submit(self, reservation: int) -> None:
        """Reject requests that could NEVER be admitted: waiting cannot
        help when the request's full reservation exceeds the whole pool
        (run_to_completion would otherwise spin forever on an
        oversubscribed pool)."""
        need = self.alloc.pages_for(reservation, self.page_size)
        if need > self.alloc.num_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.alloc.num_pages}; raise num_pages or shrink "
                "the request"
            )

    def _prompt_hashes(self, req) -> List[bytes]:
        return self._pgc.hash_pages(req.prompt, self.page_size)

    def try_admit(self, req, slot: int, reservation: int) -> Optional[int]:
        """Reserve the request's full paged footprint; ``None`` applies
        FIFO backpressure.  With the prefix cache on, cached prompt pages
        are adopted (shared, refcounted) and the return value is the
        matched token count — prefill resumes at the first un-cached
        page."""
        matched: List[int] = []
        if self.prefix_cache:
            # Cap the match so >= 1 prompt token always prefills (the
            # first sampled token needs fresh last-position logits — a
            # fully cached prompt would leave nothing to run).
            usable = (len(req.prompt) - 1) // self.page_size
            matched = self.alloc.match_prefix(
                self._prompt_hashes(req)[:usable]
            )
        need = self.alloc.pages_for(reservation, self.page_size) - len(matched)
        # Matched idle pages leave the evictable pool on adoption — count
        # them out so they are not double-counted as both "ours" and
        # "evictable".
        avail = self.alloc.free_pages + max(
            0, self.alloc.evictable_pages - len(matched)
        )
        if need > avail:
            return None
        if matched:
            self.alloc.adopt(slot, matched)
        self.alloc.allocate(slot, reservation, self.page_size)
        n_matched = len(matched) * self.page_size
        if matched:
            self.alloc.lengths[slot] = n_matched
        return n_matched

    def register_prefix(self, req) -> None:
        """Publish a fully prefilled prompt's whole pages to the prefix
        cache (pages holding any garbage tail rows past the prompt are
        never whole, so never published)."""
        hashes = self._prompt_hashes(req)
        if hashes:
            self.alloc.register(req.slot, hashes)

    def can_speculate(self, active_slots, t_width: int) -> bool:
        """Verification appends ``t_width`` rows to every active slot
        BEFORE acceptance — possibly past the admission reservation when a
        request's new-token budget is nearly spent.  Only run a round when
        the pool can cover every slot's growth (else the engine falls back
        to per-token decoding for this step)."""
        need = 0
        for s in active_slots:
            want = self.alloc.pages_for(
                int(self.alloc.lengths[s]) + t_width, self.page_size
            )
            need += max(0, want - int(self.alloc.allocated[s]))
        return need <= self.alloc.free_pages + self.alloc.evictable_pages

    # -- prefill -----------------------------------------------------------

    def _batched_page_write(self, pages, kv, page_tbl):
        """Every request's x every layer's prefill page writes as ONE
        scatter per page array (inside one jit).  The old per-(request,
        layer) ``write_tokens`` loop dispatched k x L jits per prefill
        round; requests own disjoint page sets, so a single indexed
        ``.at[:, pids].set`` is exact."""
        from .paged_cache import LayerPages

        psize = self.page_size
        kreq, n_pg = page_tbl.shape
        pids = page_tbl.reshape(-1)

        def put(dst, x):
            hkv, d = x.shape[1], x.shape[3]
            xb = x.reshape(kreq, hkv, n_pg, psize, d)
            if self.kv_int4:
                # Token-packed pages: split-halves within each page along
                # the token axis (init_layer_pages layout).
                xb = quant.pack_int4(xb, axis=3)
            xb = xb.transpose(1, 0, 2, 3, 4).reshape(
                hkv, kreq * n_pg, xb.shape[3], d
            )
            return dst.at[:, pids].set(xb)

        def put_scale(dst, s):
            hkv = s.shape[1]
            sb = s.reshape(kreq, hkv, n_pg, psize).transpose(
                1, 0, 2, 3
            ).reshape(hkv, kreq * n_pg, psize)
            if dst.ndim == 4:  # folded >128-token scale pages
                sb = sb.reshape(hkv, kreq * n_pg, psize // 128, 128)
            return dst.at[:, pids].set(sb)

        out = []
        for li, (k_l, v_l) in enumerate(kv):
            lp = pages[li]
            kq, ks = self._quantize_new(k_l.astype(jnp.float32), lp.k.dtype)
            vq, vs = self._quantize_new(v_l.astype(jnp.float32), lp.k.dtype)
            out.append(
                LayerPages(
                    k=put(lp.k, kq),
                    v=put(lp.v, vq),
                    k_scale=(
                        put_scale(lp.k_scale, ks) if ks is not None else None
                    ),
                    v_scale=(
                        put_scale(lp.v_scale, vs) if vs is not None else None
                    ),
                )
            )
        return out

    def _table_rows(self, slots: Sequence[int], padded: int) -> jax.Array:
        n_pages = -(-padded // self.page_size)
        rows = np.stack([self.alloc.tables[s, :n_pages] for s in slots])
        return jnp.asarray(rows, jnp.int32)

    def write_prefill_batch(
        self, kv, slots: Sequence[int], n_valid: Sequence[int], padded: int
    ) -> None:
        tbl = self._table_rows(slots, padded)
        if not hasattr(self, "_bw_jit"):
            self._bw_jit = jax.jit(
                self._batched_page_write, donate_argnums=_donate_args(0)
            )
        self.pages = self._bw_jit(self.pages, kv, tbl)
        for slot, n in zip(slots, n_valid):
            self.alloc.lengths[slot] = n

    def prefill_and_write(
        self, prefill_fn, params, tokens, last_pos,
        slots: Sequence[int], n_valid: Sequence[int], padded: int,
    ):
        """Prefill forward + every page write in ONE jitted dispatch
        (VERDICT r3 item 6); returns last-position logits."""
        tbl = self._table_rows(slots, padded)
        if not hasattr(self, "_pw_jit"):

            def _impl(params, pages, tokens, last_pos, tbl):
                logits, kv = prefill_fn(params, tokens, last_pos=last_pos)
                return self._batched_page_write(pages, kv, tbl), logits

            self._pw_jit = jax.jit(_impl, donate_argnums=_donate_args(1))
        self.pages, logits = self._pw_jit(
            params, self.pages, tokens,
            jnp.asarray(list(last_pos), jnp.int32), tbl,
        )
        for slot, n in zip(slots, n_valid):
            self.alloc.lengths[slot] = n
        return logits

    def _prefill_chunk_impl(
        self, params, pages, chunk_tokens, table_row, off, tc
    ):
        """Jitted (off static): one paged prefill chunk — attends to the
        page-gathered cache prefix + itself, then writes itself into this
        slot's reserved pages (mixed prefill/decode on the paged backend;
        BASELINE config 4)."""
        from ..ops.flash import flash_attention

        cfg = self.cfg
        psize = self.page_size
        width = chunk_tokens.shape[1]  # padded chunk width; tc <= width
        positions = off + jnp.arange(width, dtype=jnp.int32)
        recorded = {}

        def attend(idx, q, k_new, v_new):
            recorded[idx] = (k_new, v_new)
            lp = pages[idx]
            if off > 0:
                # off is chunk-aligned and chunks are page multiples, so
                # the prefix covers whole pages exactly.
                n_pg = off // psize
                pids = table_row[:n_pg]

                def prefix(vals, scales):
                    p = jnp.take(vals, pids, axis=1)  # (Hkv, n_pg, psize, D)
                    if self.kv_int4:
                        # Token-packed pages: (Hkv, n_pg, psize/2, D) bytes
                        # -> per-page natural token order via the axis-2
                        # split-halves unpack.
                        p = quant.unpack_int4(p, jnp.float32, axis=2)
                    else:
                        p = p.astype(jnp.float32)
                    p = p.reshape(cfg.num_kv_heads, off, cfg.head_dim)
                    if scales is not None:
                        s = jnp.take(scales, pids, axis=1).reshape(
                            cfg.num_kv_heads, off
                        )
                        p = p * s[..., None]
                    return p[None].astype(jnp.bfloat16)

                k_all = jnp.concatenate(
                    [prefix(lp.k, lp.k_scale), k_new.astype(jnp.bfloat16)],
                    axis=2,
                )
                v_all = jnp.concatenate(
                    [prefix(lp.v, lp.v_scale), v_new.astype(jnp.bfloat16)],
                    axis=2,
                )
            else:
                k_all, v_all = k_new, v_new
            return flash_attention(
                q, k_all, v_all, is_causal=True, q_offset=jnp.int32(off),
                window=window_of(cfg),
            )

        logits = llama.forward_chunk(params, chunk_tokens, positions, cfg, attend)
        first_pg = off // psize
        n_pg_chunk = width // psize
        pids_chunk = table_row[first_pg : first_pg + n_pg_chunk]
        for li in range(cfg.num_layers):
            k_l, v_l = recorded[li]
            # Full-width writes into this slot's own reserved pages; rows
            # beyond tc hold garbage that lengths mask and the next chunk
            # (or the first decode append) overwrites.
            pages[li] = self._pgc.write_tokens(
                pages[li], pids_chunk, 0,
                k_l[0].astype(jnp.float32), v_l[0].astype(jnp.float32),
            )
        del tc  # traced; only threaded through for jit-cache keying parity
        return pages, logits

    def prefill_chunk(self, params, tokens, req, off: int, tc: int):
        if not hasattr(self, "_chunk_jit"):
            self._chunk_jit = jax.jit(
                self._prefill_chunk_impl, static_argnames=("off",)
            )
        table_row = jnp.asarray(self.alloc.tables[req.slot], jnp.int32)
        self.pages, logits = self._chunk_jit(
            params, self.pages, tokens, table_row, off=off, tc=jnp.int32(tc)
        )
        self.alloc.lengths[req.slot] = off + tc
        return logits

    # -- decode ------------------------------------------------------------

    def _write_tokens_step(
        self, pages_arrays, tables, positions, active_mask, kq, vq, ks, vs,
        t_width: int = 1,
    ):
        """In-jit write of ``t_width`` already-quantized tokens per slot at
        dynamic (non page-aligned) offsets.  Token t of slot i lands at
        position positions[i] + t in page
        tables[i, (positions[i]+t) // page_size].

        8-bit/bf16 pages: ONE batched scatter per page array — the
        per-slot fori_loop of dynamic updates serialized ~6 tiny ops x
        num_slots x num_layers inside every decode step and was the bulk
        of the paged backend's 1.48x step-time gap vs slots
        (benchmarks/paged_vs_slots_bench.py).  Inactive slots' lanes are
        redirected to the dedicated trash page (their table rows may point
        at pages now owned by other sequences).  Token-packed int4 pages
        keep the loop (nibble read-modify-write has no scatter form)."""
        psize = self.page_size
        quantized = ks is not None
        int4 = self.kv_int4

        if not int4:
            kpg, vpg, kspg, vspg = pages_arrays
            n = self.num_slots * t_width
            if t_width > 1:
                hkv, d = kq.shape[1], kq.shape[3]
                kv_k = kq.transpose(0, 2, 1, 3).reshape(n, hkv, d)
                kv_v = vq.transpose(0, 2, 1, 3).reshape(n, hkv, d)
                lane_pos = (
                    positions[:, None]
                    + jnp.arange(t_width, dtype=jnp.int32)[None, :]
                ).reshape(-1)
                lane_act = jnp.repeat(active_mask, t_width)
                lane_row = jnp.repeat(
                    jnp.arange(self.num_slots, dtype=jnp.int32), t_width
                )
                s_k = ks.transpose(0, 2, 1).reshape(n, -1) if quantized else None
                s_v = vs.transpose(0, 2, 1).reshape(n, -1) if quantized else None
            else:
                kv_k, kv_v = kq, vq
                lane_pos = positions
                lane_act = active_mask
                lane_row = jnp.arange(self.num_slots, dtype=jnp.int32)
                s_k, s_v = ks, vs
            page = tables[lane_row, lane_pos // psize]
            page = jnp.where(lane_act, page, self._trash_page)
            off = lane_pos % psize
            kpg = kpg.at[:, page, off].set(kv_k.transpose(1, 0, 2))
            vpg = vpg.at[:, page, off].set(kv_v.transpose(1, 0, 2))
            if quantized:
                # s_k/s_v: (n, Hkv) -> (Hkv, n) for the dims-1,2 scatter.
                if kspg.ndim == 4:  # folded >128-token scale pages
                    idx = (slice(None), page, off // 128, off % 128)
                else:
                    idx = (slice(None), page, off)
                kspg = kspg.at[idx].set(jnp.swapaxes(s_k, 0, 1))
                vspg = vspg.at[idx].set(jnp.swapaxes(s_v, 0, 1))
            return kpg, vpg, kspg, vspg

        def body(idx, carry):
            kpg, vpg, kspg, vspg = carry
            i = idx // t_width
            t = idx % t_width
            pos = positions[i] + t
            page = tables[i, pos // psize]
            off = pos % psize

            def write(c):
                kpg, vpg, kspg, vspg = c
                kt = kq[i, :, t, :] if t_width > 1 else kq[i]
                vt = vq[i, :, t, :] if t_width > 1 else vq[i]
                if int4:
                    # Token-packed pages: token ``off`` lives in byte row
                    # off % (psize/2) — low nibble for the first half of
                    # the page, high nibble for the second.  RMW the one
                    # byte row; int32 math avoids int8 shift-overflow
                    # pitfalls.
                    half = psize // 2
                    low = off < half
                    row = jnp.where(low, off, off - half)

                    def nib(dst, val):
                        hkv, d = val.shape
                        old = jax.lax.dynamic_slice(
                            dst, (0, page, row, 0), (hkv, 1, 1, d)
                        ).astype(jnp.int32)
                        v32 = (
                            val[:, None, None, :].astype(jnp.int32) & 0xF
                        )
                        new = jnp.where(
                            low,
                            (old & ~0xF) | v32,
                            (old & 0xF) | (v32 << 4),
                        )
                        return jax.lax.dynamic_update_slice(
                            dst, new.astype(jnp.int8), (0, page, row, 0)
                        )

                    kpg = nib(kpg, kt)
                    vpg = nib(vpg, vt)
                else:
                    kpg = jax.lax.dynamic_update_slice(
                        kpg, kt[:, None, None, :], (0, page, off, 0)
                    )
                    vpg = jax.lax.dynamic_update_slice(
                        vpg, vt[:, None, None, :], (0, page, off, 0)
                    )
                if quantized:
                    kst = ks[i, :, t] if t_width > 1 else ks[i]
                    vst = vs[i, :, t] if t_width > 1 else vs[i]
                    if kspg.ndim == 4:  # folded >128-token scale pages
                        kspg = jax.lax.dynamic_update_slice(
                            kspg, kst[:, None, None, None],
                            (0, page, off // 128, off % 128),
                        )
                        vspg = jax.lax.dynamic_update_slice(
                            vspg, vst[:, None, None, None],
                            (0, page, off // 128, off % 128),
                        )
                    else:
                        kspg = jax.lax.dynamic_update_slice(
                            kspg, kst[:, None, None], (0, page, off)
                        )
                        vspg = jax.lax.dynamic_update_slice(
                            vspg, vst[:, None, None], (0, page, off)
                        )
                return kpg, vpg, kspg, vspg

            return jax.lax.cond(active_mask[i], write, lambda c: c, carry)

        return jax.lax.fori_loop(
            0, self.num_slots * t_width, body, pages_arrays
        )

    def _quantize_new(self, x, dtype):
        """(B, Hkv, [T,] D) float -> (values, scales) in the page container."""
        from ..utils import checks

        if not checks.is_8bit_dtype(dtype):
            return x.astype(dtype), None
        if self.kv_int4:
            fn = quant.quantize_int4_values
        elif dtype == jnp.int8:
            fn = quant.dynamically_quantize_int8
        else:
            fn = quant.dynamically_quantize_fp8
        return fn(x.astype(jnp.float32), reduction_dim=-1)

    def _attend_step(self, pages, idx, q, k_new, v_new, tables, positions,
                     active_mask, t_width: int = 1):
        """Shared decode/verify attend: quantize + write the new tokens of
        layer ``idx`` into its pages, then run the async-DMA paged kernel.
        ``k_new``/``v_new`` are (B, Hkv, D) for decode or (B, Hkv, T, D)
        for verification."""
        from ..ops.paged import paged_decode_attention
        from .paged_cache import LayerPages

        lp = pages[idx]
        quantized = lp.k_scale is not None
        kq, ks = self._quantize_new(k_new, lp.k.dtype)
        vq, vs = self._quantize_new(v_new, lp.k.dtype)
        kspg = lp.k_scale if quantized else jnp.zeros((0,), jnp.float32)
        vspg = lp.v_scale if quantized else jnp.zeros((0,), jnp.float32)
        kpg, vpg, kspg, vspg = self._write_tokens_step(
            (lp.k, lp.v, kspg, vspg), tables, positions, active_mask,
            kq, vq, ks, vs, t_width=t_width,
        )
        pages[idx] = LayerPages(
            k=kpg,
            v=vpg,
            k_scale=kspg if quantized else None,
            v_scale=vspg if quantized else None,
        )
        new_lengths = positions + active_mask.astype(jnp.int32) * t_width
        return paged_decode_attention(
            q.astype(jnp.bfloat16),
            kpg,
            vpg,
            new_lengths,
            tables,
            k_scale_pages=kspg if quantized else None,
            v_scale_pages=vspg if quantized else None,
            window=window_of(self.cfg),
        )

    def _decode_step_impl(
        self, params, pages, tokens, tables, positions, active_mask
    ):
        """Jitted: one decode step over all slots, paged backend.

        Writes each active slot's new K/V token into its current page, then
        runs the async-DMA paged attention kernel per layer."""

        def attend(idx, q, k_new, v_new):
            return self._attend_step(
                pages, idx, q, k_new, v_new, tables, positions, active_mask
            )

        logits = llama.forward_decode(
            params, tokens, positions, self.cfg, attend
        )
        return pages, logits

    def decode(self, params, tokens, active_mask, active_slots):
        # Admission reserved every slot's full footprint, so allocate() is
        # a no-op growth here — kept as a guard for the invariant.
        for slot in active_slots:
            self.alloc.allocate(
                slot, int(self.alloc.lengths[slot]) + 1, self.page_size
            )
        positions = jnp.asarray(self.alloc.lengths)
        tables = jnp.asarray(self.alloc.tables)
        self.pages, logits = self._decode_jit(
            params, self.pages, jnp.asarray(tokens), tables, positions,
            jnp.asarray(active_mask),
        )
        for slot in active_slots:
            self.alloc.lengths[slot] += 1
        return logits

    def _burst_impl(
        self, params, pages, tables, tokens, positions, active, remaining,
        eos_ids, key, *, n_steps: int, sp: SamplingParams,
        want_lp: bool = False,
    ):
        """Jitted: ``n_steps`` paged decode steps in one ``lax.scan``.

        The page tables are FIXED across the burst (admission reserved the
        full horizon), so only positions/active advance in the carry —
        page-table growth never blocks the scan.  Same trace contract as
        the slots burst: one packed (tokens, emitted[, logprob]) array per
        burst, one host fetch."""

        def one(carry, _):
            pages, tokens, positions, active, remaining, key = carry

            def attend(idx, q, k_new, v_new):
                return self._attend_step(
                    pages, idx, q, k_new, v_new, tables, positions, active
                )

            logits = llama.forward_decode(
                params, tokens, positions, self.cfg, attend
            )
            positions = positions + active.astype(jnp.int32)
            key, sub = jax.random.split(key)
            skey = None if sp.temperature == 0.0 else sub
            if want_lp:
                nxt, lp = sample_with_logprob(logits, sp, skey)
            else:
                nxt = sample(logits, sp, skey)
                lp = jnp.zeros(nxt.shape, jnp.float32)
            emitted = active
            nxt = jnp.where(active, nxt, tokens)
            remaining = remaining - active.astype(jnp.int32)
            hit_eos = jnp.logical_and(nxt == eos_ids, eos_ids >= 0)
            active = jnp.logical_and(
                active, jnp.logical_and(~hit_eos, remaining > 0)
            )
            return (
                (pages, nxt, positions, active, remaining, key),
                (nxt, emitted, lp),
            )

        (pages, *_), (toks, emits, lps) = jax.lax.scan(
            one, (pages, tokens, positions, active, remaining, key), None,
            length=n_steps,
        )
        if want_lp:
            packed = jnp.stack(
                [toks.astype(jnp.float32), emits.astype(jnp.float32), lps]
            )
        else:
            packed = jnp.stack([toks, emits.astype(jnp.int32)])
        return pages, packed

    def _flush_side_pages(self, pages, sides, tables, base, n_side):
        """Persist a burst's side-buffer tokens into the page pool: ONE
        batched scatter per page array per BURST (the per-step write this
        replaces was silently copying the whole pool every step — a
        scatter whose output feeds a pallas kernel cannot alias,
        benchmarks/append_probe.py).  Side column t of slot b lands at
        position base[b] + t; columns past a slot's last active step are
        contract-garbage and their lanes are redirected to the trash
        page."""
        from .paged_cache import LayerPages

        psize = self.page_size
        tpad = sides[0][0].shape[2]
        batch = self.num_slots
        t_idx = jnp.arange(tpad, dtype=jnp.int32)[None, :]
        lane_pos = base[:, None] + t_idx  # (B, Tpad)
        lane_act = (t_idx < n_side[:, None]).reshape(-1)
        lane_row = jnp.broadcast_to(
            jnp.arange(batch, dtype=jnp.int32)[:, None], (batch, tpad)
        ).reshape(-1)
        pidx = jnp.clip(
            lane_pos.reshape(-1) // psize, 0, tables.shape[1] - 1
        )
        page = jnp.where(
            lane_act, tables[lane_row, pidx], self._trash_page
        )
        off = lane_pos.reshape(-1) % psize
        n = batch * tpad
        out = []
        for (sk, sv, sks, svs), lp in zip(sides, pages):
            hkv, d = sk.shape[1], sk.shape[3]
            kv_k = sk.transpose(0, 2, 1, 3).reshape(n, hkv, d)
            kv_v = sv.transpose(0, 2, 1, 3).reshape(n, hkv, d)
            kpg = lp.k.at[:, page, off].set(kv_k.transpose(1, 0, 2))
            vpg = lp.v.at[:, page, off].set(kv_v.transpose(1, 0, 2))
            kspg, vspg = lp.k_scale, lp.v_scale
            if sks is not None:
                s_k = sks.transpose(0, 2, 1).reshape(n, hkv)
                s_v = svs.transpose(0, 2, 1).reshape(n, hkv)
                if kspg.ndim == 4:  # folded >128-token scale pages
                    idx = (slice(None), page, off // 128, off % 128)
                else:
                    idx = (slice(None), page, off)
                kspg = kspg.at[idx].set(jnp.swapaxes(s_k, 0, 1))
                vspg = vspg.at[idx].set(jnp.swapaxes(s_v, 0, 1))
            out.append(
                LayerPages(k=kpg, v=vpg, k_scale=kspg, v_scale=vspg)
            )
        return out

    def _burst_impl_side(
        self, params, pages, tables, tokens, positions, active, remaining,
        eos_ids, key, *, n_steps: int, sp: SamplingParams,
        want_lp: bool = False,
    ):
        """Jitted side-buffer burst: the page pool stays INVARIANT for the
        whole scan (the per-step page scatter of ``_burst_impl`` feeds the
        paged pallas kernel, so XLA silently COPIES every pool array each
        step — copy cost scales with POOL bytes, the same trap the slots
        backend shed in round 5).  Each step appends its quantized tokens
        to a small per-layer side buffer with one shared-row
        dynamic_update_slice (the only write form that stays in place
        through a pallas consumer — benchmarks/append_probe.py), the
        paged kernel attends cache-prefix pages + side buffer, and
        ``_flush_side_pages`` persists the side tokens ONCE after the
        scan."""
        from ..ops.paged import MASK_VALUE, paged_decode_attention

        cfg = self.cfg
        batch = self.num_slots
        hkv, d = cfg.num_kv_heads, cfg.head_dim
        base = positions
        tpad = round_up(n_steps, 8)
        cdt = pages[0].k.dtype
        quantized = pages[0].k_scale is not None
        zk = jnp.zeros((batch, hkv, tpad, d), cdt)
        ones = (
            jnp.ones((batch, hkv, tpad), jnp.float32) if quantized else None
        )
        sides0 = [(zk, zk, ones, ones) for _ in range(cfg.num_layers)]
        smask0 = jnp.full((batch, tpad), MASK_VALUE, jnp.float32)

        def one(carry, t):
            sides, smask, toks, pos, active, remaining, key = carry
            # Current tokens become visible to themselves via the side
            # mask (the scatter path's append-then-attend semantics).
            smask = jax.lax.dynamic_update_slice(
                smask,
                jnp.where(active, 0.0, MASK_VALUE).astype(jnp.float32)[
                    :, None
                ],
                (0, t),
            )
            sides = list(sides)

            def attend(idx, q, k_new, v_new):
                lp = pages[idx]
                kq, ks = self._quantize_new(
                    k_new.astype(jnp.float32), lp.k.dtype
                )
                vq, vs = self._quantize_new(
                    v_new.astype(jnp.float32), lp.k.dtype
                )
                sk, sv, sks, svs = sides[idx]
                sk = jax.lax.dynamic_update_slice(
                    sk, kq[:, :, None, :], (0, 0, t, 0)
                )
                sv = jax.lax.dynamic_update_slice(
                    sv, vq[:, :, None, :], (0, 0, t, 0)
                )
                if quantized:
                    sks = jax.lax.dynamic_update_slice(
                        sks, ks[:, :, None], (0, 0, t)
                    )
                    svs = jax.lax.dynamic_update_slice(
                        svs, vs[:, :, None], (0, 0, t)
                    )
                sides[idx] = (sk, sv, sks, svs)
                side = {"k": sk, "v": sv, "mask": smask}
                if quantized:
                    side["ks"], side["vs"] = sks, svs
                return paged_decode_attention(
                    q.astype(jnp.bfloat16), lp.k, lp.v, base, tables,
                    k_scale_pages=lp.k_scale, v_scale_pages=lp.v_scale,
                    side=side,
                )

            logits = llama.forward_decode(params, toks, pos, cfg, attend)
            pos = pos + active.astype(jnp.int32)
            key, sub = jax.random.split(key)
            skey = None if sp.temperature == 0.0 else sub
            if want_lp:
                nxt, lp_ = sample_with_logprob(logits, sp, skey)
            else:
                nxt = sample(logits, sp, skey)
                lp_ = jnp.zeros(nxt.shape, jnp.float32)
            emitted = active
            nxt = jnp.where(active, nxt, toks)
            remaining = remaining - active.astype(jnp.int32)
            hit_eos = jnp.logical_and(nxt == eos_ids, eos_ids >= 0)
            active = jnp.logical_and(
                active, jnp.logical_and(~hit_eos, remaining > 0)
            )
            return (
                (sides, smask, nxt, pos, active, remaining, key),
                (nxt, emitted, lp_),
            )

        carry0 = (sides0, smask0, tokens, base, active, remaining, key)
        (sides, _, _, pos_f, *_), (toks, emits, lps) = jax.lax.scan(
            one, carry0, jnp.arange(n_steps, dtype=jnp.int32)
        )
        pages = self._flush_side_pages(
            pages, sides, tables, base, pos_f - base
        )
        if want_lp:
            packed = jnp.stack(
                [toks.astype(jnp.float32), emits.astype(jnp.float32), lps]
            )
        else:
            packed = jnp.stack([toks, emits.astype(jnp.int32)])
        return pages, packed

    def burst(
        self, params, tokens, active, remaining, eos_ids, key,
        n_steps: int, sp: SamplingParams, want_lp: bool,
        host_active=None,
    ) -> np.ndarray:
        # Pre-reserve the burst horizon (no-op growth: admission already
        # reserved prompt + max_new_tokens, and the engine clamps n_steps
        # to every request's remaining budget).  ``host_active``: the
        # eager fetch-overlap burst passes DEVICE token/active arrays
        # (engine._decode_burst_eager) — host bookkeeping must use its
        # optimistic host mask, not fetch the device one element-wise.
        act_h = host_active if host_active is not None else active
        for slot in range(self.num_slots):
            if act_h[slot]:
                self.alloc.allocate(
                    slot, int(self.alloc.lengths[slot]) + n_steps,
                    self.page_size,
                )
        # Side-buffer burst: page pool scan-invariant, one flush per
        # burst.  Gated off for int4 pages (no scatter form / no side
        # kernel path) and windowed models (the side block has no window
        # term yet); those keep the per-step scatter burst.
        from .. import config as qa_config

        use_side = (
            bool(qa_config.kernel.paged_side_burst)
            and n_steps <= 128
            and not self.kv_int4
            and window_of(self.cfg) is None
        )
        jitted = self._burst_jits.get((n_steps, sp, want_lp, use_side))
        if jitted is None:
            impl = self._burst_impl_side if use_side else self._burst_impl
            jitted = jax.jit(
                functools.partial(
                    impl, n_steps=n_steps, sp=sp, want_lp=want_lp
                ),
                donate_argnums=_donate_args(1),
            )
            self._burst_jits[(n_steps, sp, want_lp, use_side)] = jitted
        self.pages, packed = jitted(
            params, self.pages, jnp.asarray(self.alloc.tables),
            jnp.asarray(tokens), jnp.asarray(self.alloc.lengths),
            jnp.asarray(active), jnp.asarray(remaining),
            jnp.asarray(eos_ids), key,
        )
        packed = np.asarray(packed)  # one fixed-cost fetch per burst
        # Reconcile host lengths: a slot advanced once per step it was
        # active at step start (== its emitted count).
        emits = (
            (packed[1] != 0.0) if want_lp else packed[1].astype(bool)
        )
        self.alloc.lengths += emits.sum(axis=0).astype(np.int32)
        return packed

    # -- speculative decoding ------------------------------------------------

    def _verify_impl(self, params, pages, tokens, tables, positions,
                     active_mask):
        """Jitted: multi-token target verification on the paged backend.

        Appends the T candidate tokens of every active slot into its pages
        (dynamic in-page offsets), then scores all T positions in one
        forward via the paged kernel's multi-query mode (ops/paged.py
        q_tokens — the M dim packs (group, token) pairs with per-row
        intra-chunk causal masking).  Rollback is a host lengths reset:
        rows past ``lengths`` are garbage by contract and the next write
        overwrites them."""
        cfg = self.cfg
        t_width = tokens.shape[1]
        pos2d = positions[:, None] + jnp.arange(t_width, dtype=jnp.int32)

        def attend(idx, q, k_new, v_new):
            return self._attend_step(
                pages, idx, q, k_new, v_new, tables, positions, active_mask,
                t_width=t_width,
            )

        logits = llama.forward_chunk(params, tokens, pos2d, cfg, attend)
        return pages, logits

    def verify(self, params, cand, positions, active_mask):
        t_width = int(cand.shape[1])
        for slot in range(self.num_slots):
            if active_mask[slot]:
                self.alloc.allocate(
                    slot, int(self.alloc.lengths[slot]) + t_width,
                    self.page_size,
                )
        tables = jnp.asarray(self.alloc.tables)
        self.pages, logits = self._verify_jit(
            params, self.pages, cand, tables, jnp.asarray(positions),
            jnp.asarray(active_mask),
        )
        return logits

    def rollback(self, rollback_mask, new_lengths) -> None:
        self.alloc.lengths = np.where(
            np.asarray(rollback_mask), np.asarray(new_lengths, np.int32),
            self.alloc.lengths,
        ).astype(np.int32)

    # -- bookkeeping ---------------------------------------------------------

    def host_lengths(self) -> np.ndarray:
        return np.asarray(self.alloc.lengths)

    def release(self, slot: int) -> None:
        self.alloc.release(slot)
