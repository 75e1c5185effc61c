"""Continuous-batching inference engine (scheduling layer).

The reference stops at the kernel boundary; this engine is this build's
serving extension (BASELINE.md decode config): slot-based continuous
batching over a quantized ragged KV cache, with mixed prefill/decode
scheduling and a fully-jitted decode step.

Architecture (jit-stability first):
  * cache STATE lives behind one of two backends (``serving/backends.py``):
    ``SlotsBackend`` (contiguous per-slot rows) or ``PagedBackend``
    (vLLM-style page pool + tables + refcounted prefix cache).  This
    module never touches arrays directly — it does admission, scheduling,
    sampling, and emission only;
  * the cache has a fixed number of slots (max concurrent sequences) and
    a fixed max length — all jitted functions see static shapes;
  * prefill is chunked (both backends): every engine ``step()`` advances at
    most ONE prefill chunk and then runs ONE decode step over all active
    slots, so live decode streams keep producing tokens while long prompts
    prefill (true continuous batching — a long prompt can no longer stall
    the fleet);
  * decode runs over ALL slots every step (inactive slots have length 0,
    whose KV blocks the kernel skips via the scalar-prefetched lengths);
  * paged backend: admission makes a FULL reservation (prompt padding AND
    max_new_tokens) before a request leaves the waiting queue, so neither
    prefill nor any later decode step can run out of pages mid-stream;
  * the Python layer does admission/eviction only — no tensor math;
  * per-token streaming via ``on_token`` callbacks.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import llama
from ..utils import checks
from ..utils.shapes import round_up
from .backends import PagedBackend, SlotsBackend, _chunk_prefix_attend  # noqa: F401  (re-export: serving/tp.py shard-maps _chunk_prefix_attend)
from .sampling import SamplingParams, sample, sample_with_logprob


@dataclasses.dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    #: Streaming callback: called as ``on_token(token_id, request)`` for
    #: every generated token, in order, as soon as it is sampled.
    on_token: Optional[Callable[[int, "Request"], None]] = None
    #: Record a log-probability for every generated token in
    #: ``logprob_output`` (sampling.sample_with_logprob convention: raw
    #: softmax for greedy, the post-filter distribution otherwise).
    #: Requests with logprobs are excluded from speculative rounds (the
    #: engine decodes them per-token/burst instead).
    logprobs: bool = False
    # Filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    logprob_output: List[float] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    #: Number of prompt tokens already prefilled (chunked prefill state).
    prefill_pos: int = 0
    #: Whole-batch prefill forward already submitted to the device; the
    #: first-token fetch is pending (engine._pending_prefill pipelining).
    dispatched: bool = False


class Engine:
    """Continuous-batching engine over a Llama-family model."""

    def __init__(
        self,
        params: llama.Params,
        cfg: llama.LlamaConfig,
        *,
        num_slots: int = 8,
        max_len: int = 2048,
        cache_dtype=jnp.int8,
        kv_int4: bool = False,
        prefill_bucket: int = 128,
        decode_block_kv: Optional[int] = None,
        seed: int = 0,
        cache_backend: str = "slots",
        page_size: int = 128,
        num_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        draft: Optional[Tuple[llama.Params, llama.LlamaConfig]] = None,
        spec_tokens: int = 4,
        mesh=None,
        tp_axis: str = "tp",
    ) -> None:
        if cache_backend not in ("slots", "paged"):
            raise ValueError(f"unknown cache_backend: {cache_backend!r}")
        if mesh is not None:
            # Tensor-parallel serving (serving/tp.py): Megatron-sharded
            # weights, KV-head-sharded caches, shard_mapped kernels.
            if cache_backend != "slots":
                raise ValueError("mesh serving requires the slots backend")
            if draft is not None:
                raise ValueError(
                    "speculative decoding is a single-chip path (the "
                    "multi-query verification kernel is not head-sharded)"
                )
            n = mesh.shape[tp_axis]
            if cfg.num_kv_heads % n or cfg.num_q_heads % n:
                raise ValueError(
                    f"num_q_heads ({cfg.num_q_heads}) and num_kv_heads "
                    f"({cfg.num_kv_heads}) must be divisible by the "
                    f"'{tp_axis}' axis size ({n})"
                )
        self.mesh = mesh
        self.tp_axis = tp_axis
        if prefill_chunk is not None and max_len % prefill_chunk != 0:
            # Chunk writes are full-width (bounded jit cache: one compile
            # per chunk offset); alignment guarantees they never run past
            # the cache end.
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of prefill_chunk "
                f"({prefill_chunk})"
            )
        if cache_backend == "paged":
            # Page-alignment invariants: prefill writes are padded to
            # prefill_bucket / prefill_chunk widths and mapped onto whole
            # pages, so both must be page multiples (a misaligned bucket
            # would floor-divide to too few pages and silently spill the
            # tail into the wrong page).
            if max_len % page_size != 0:
                raise ValueError(
                    f"max_len ({max_len}) must be a multiple of page_size "
                    f"({page_size})"
                )
            if prefill_bucket % page_size != 0:
                raise ValueError(
                    f"prefill_bucket ({prefill_bucket}) must be a multiple "
                    f"of page_size ({page_size})"
                )
            if prefill_chunk is not None and prefill_chunk % page_size != 0:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must be a multiple "
                    f"of page_size ({page_size})"
                )
        if prefix_cache:
            # Automatic prefix caching (vLLM-style): matched requests skip
            # straight to the first un-cached page and prefill the rest
            # through the CHUNKED path, which requires the paged backend
            # (shared pages live in page tables) and a chunk size (the
            # resume offset is page-aligned, not bucket-aligned).
            if cache_backend != "paged":
                raise ValueError("prefix_cache requires the paged backend")
            if prefill_chunk is None:
                raise ValueError("prefix_cache requires prefill_chunk")
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.decode_block_kv = decode_block_kv
        self.cache_backend = cache_backend
        self.page_size = page_size
        if kv_int4 and not checks.is_8bit_dtype(cache_dtype):
            raise ValueError("kv_int4 requires an 8-bit cache_dtype")
        self.kv_int4 = kv_int4
        if draft is not None:
            draft_params, draft_cfg = draft
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary "
                    f"({draft_cfg.vocab_size} vs {cfg.vocab_size})"
                )
            if spec_tokens < 1:
                raise ValueError("spec_tokens must be >= 1")
            self.draft_params, self.draft_cfg = draft_params, draft_cfg
            self.spec_tokens = int(spec_tokens)
            self._draft_prefilled: set = set()
        else:
            self.draft_params = None
        if cache_backend == "slots":
            self._backend = SlotsBackend(
                cfg, num_slots=num_slots, max_len=max_len,
                cache_dtype=cache_dtype, kv_int4=kv_int4,
                decode_block_kv=decode_block_kv, mesh=mesh, tp_axis=tp_axis,
            )
        else:
            self._backend = PagedBackend(
                cfg, num_slots=num_slots, max_len=max_len,
                cache_dtype=cache_dtype, kv_int4=kv_int4,
                page_size=page_size, num_pages=num_pages,
                decode_block_kv=decode_block_kv,
                prefix_cache=prefix_cache,
            )
        self.free_slots = list(range(num_slots))
        self.active: Dict[int, Request] = {}  # slot -> request
        self.waiting: List[Request] = []
        self.prefilling: List[Request] = []  # admitted, chunks pending
        #: Dispatched-but-unfetched whole-batch prefill (reqs, device
        #: first-token arrays): the fetch of group N's first tokens is
        #: deferred until group N+1's forward has been SUBMITTED, so the
        #: device-to-host copy rides under the next group's compute.
        self._pending_prefill: Optional[tuple] = None
        #: run_to_completion sets this so the LAST group's resolve defers
        #: into the first decode burst (fetch overlap).
        self._defer_last_resolve = False
        self._eager_merge_jit = None
        self.finished: List[Request] = []
        self.last_token = np.zeros((num_slots,), np.int32)
        self._req_ids = itertools.count()
        #: Serving observability (SURVEY §5 notes the reference ships no
        #: metrics; a production engine needs at least these counters).
        self.stats: Dict[str, int] = {
            "prefill_tokens": 0,
            "prefill_forwards": 0,
            "decode_steps": 0,
            "generated_tokens": 0,
            "spec_rounds": 0,
            "spec_proposed": 0,
            "spec_accepted": 0,
            "prefix_hits": 0,
            "prefix_tokens_reused": 0,
        }
        self._key = jax.random.PRNGKey(seed)

        if mesh is not None:
            from . import tp as tp_lib

            self.params = tp_lib.shard_serving_params(self.params, cfg, mesh)
            self._prefill_fn = functools.partial(
                tp_lib.forward_prefill_tp, cfg=cfg, mesh=mesh, axis=tp_axis
            )
        else:
            self._prefill_fn = functools.partial(
                llama.forward_prefill, cfg=cfg
            )
        self._prefill_jit = jax.jit(self._prefill_fn)
        if self.draft_params is not None:
            # The draft model always runs on a private slot cache (small,
            # single-chip) regardless of the target's backend.
            self._draft_backend = SlotsBackend(
                self.draft_cfg, num_slots=num_slots, max_len=max_len,
                cache_dtype=cache_dtype,
                decode_block_kv=decode_block_kv,
            )
            self._draft_prefill_fn = functools.partial(
                llama.forward_prefill, cfg=self.draft_cfg
            )

    # ------------------------------------------------------------------
    # Backend state views (benchmarks and tests read these)
    # ------------------------------------------------------------------

    @property
    def caches(self):
        return self._backend.caches

    @caches.setter
    def caches(self, value):
        self._backend.caches = value

    @property
    def pages(self):
        return self._backend.pages

    @property
    def alloc(self):
        return self._backend.alloc

    @property
    def draft_caches(self):
        return self._draft_backend.caches

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    @classmethod
    def from_hf(
        cls,
        checkpoint_path: str,
        *,
        dtype=None,
        quantize_weights=False,
        fuse_projections: bool = False,
        **engine_kwargs,
    ):
        """Engine over an on-disk HuggingFace checkpoint directory
        (``config.json`` + safetensors — ``models/hf.load_hf_checkpoint``;
        cross-framework logit parity tested in tests/test_hf.py).
        ``quantize_weights=True`` (or "int8") stores projections int8
        per-output-channel (w8a16) — required to fit 8B-class weights on
        one chip; "int4" stores decoder projections group-wise w4a16
        (half the bytes again, +11%% decode tok/s measured — see
        models/quantized.quantize_params_int4).
        ``fuse_projections=True`` (single-chip serving only, requires
        quantized weights) fuses [wq|wk|wv] and [gate|up] to cut per-layer
        matmul op count — see models/quantized.fuse_projections."""
        from ..models import hf as hf_lib

        params, cfg = hf_lib.load_hf_checkpoint(
            checkpoint_path, dtype=dtype, quantize_weights=quantize_weights
        )
        if fuse_projections:
            if not quantize_weights:
                raise ValueError(
                    "fuse_projections requires quantize_weights=True "
                    "(fusion operates on the w8a16 tree)"
                )
            from ..models import quantized as qz

            params = qz.fuse_projections(params)
        return cls(params, cfg, **engine_kwargs)

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
        on_token: Optional[Callable[[int, Request], None]] = None,
        logprobs: bool = False,
    ) -> Request:
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds cache max_len ({self.max_len})"
            )
        req = Request(
            id=next(self._req_ids),
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            sampling=sampling or SamplingParams(),
            on_token=on_token,
            logprobs=logprobs,
        )
        self._backend.check_submit(self._reservation_tokens(req))
        self.waiting.append(req)
        return req

    def step(self) -> List[Request]:
        """One engine step of mixed prefill/decode scheduling.

        Admits waiting requests (with full paged reservations), advances
        prefill — one chunk of a chunked prompt, or ONE batched forward
        over every same-bucket whole prompt — then runs ONE decode step
        over every active slot, so decode streams keep producing tokens
        while long prompts prefill (BASELINE config 4's continuous-
        batching contract).  Returns requests that finished this step.
        """
        return self._step_inner()

    def _step_inner(self) -> List[Request]:
        self._admit()
        if self.prefilling:
            self._prefill_advance_group()
        elif self._pending_prefill is not None:
            self._resolve_pending_prefill()
        newly_finished: List[Request] = []
        if self.active:
            if self._spec_applicable():
                newly_finished = self._speculative_round()
            else:
                newly_finished = self._decode()
        return newly_finished

    def run_to_completion(self, decode_burst: Optional[int] = None) -> List[Request]:
        """Drive step() until every submitted request is done.

        ``decode_burst``: when > 1 and the engine is in a pure-decode phase
        (nothing waiting or prefilling, identical sampling params), run up
        to that many decode steps inside ONE jitted scan — one host
        dispatch per burst instead of per token (sampling, EOS detection,
        and per-request budgets all happen on device; the paged backend
        scans over its pre-reserved page tables).
        """
        out: List[Request] = []
        # Defer the LAST prefill group's first-token resolve so the burst
        # driver can overlap its fixed ~30-38 ms fetch with the first
        # decode burst's compute (_decode_burst_eager).
        self._defer_last_resolve = bool(
            decode_burst and decode_burst > 1 and self.draft_params is None
        )
        try:
            while self.waiting or self.prefilling or self.active:
                n = self._burst_size(decode_burst)
                if n > 1:
                    out.extend(self._decode_burst(n))
                    continue
                n = self._eager_burst_size(decode_burst)
                if n > 1:
                    out.extend(self._decode_burst_eager(n))
                else:
                    out.extend(self._step_inner())
        finally:
            self._defer_last_resolve = False
        return out

    def _burst_size(self, decode_burst: Optional[int]) -> int:
        """Largest safe decode burst right now (1 = use the per-step path)."""
        if not decode_burst or decode_burst <= 1:
            return 1
        if self.draft_params is not None:
            return 1  # speculative rounds already batch tokens per dispatch
        if self.waiting or self.prefilling or not self.active:
            return 1  # mixed prefill/decode must interleave per step
        reqs = list(self.active.values())
        if len({r.sampling for r in reqs}) != 1:
            return 1  # on-device sampling is shared across the burst
        n = decode_burst
        for r in reqs:
            n = min(n, r.max_new_tokens - len(r.output))
            n = min(n, self.max_len - len(r.prompt) - len(r.output))
        return max(n, 1)

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        sampling: Optional[SamplingParams] = None,
    ) -> List[List[int]]:
        """Batch convenience: submit every prompt, run to completion,
        return outputs in submission order."""
        reqs = [
            self.submit(p, max_new_tokens, eos_id=eos_id, sampling=sampling)
            for p in prompts
        ]
        self.run_to_completion()
        return [r.output for r in reqs]

    # ------------------------------------------------------------------
    # Prefill / admission
    # ------------------------------------------------------------------

    def _reservation_tokens(self, req: Request) -> int:
        """Exact token capacity this request's prefill + decode will use:
        the prompt padded to its prefill width (bucket or chunk), and room
        for every potential new token.  The paged admission check and the
        allocation reserve the SAME quantity, so a request that is admitted
        can never hit an out-of-pages error mid-stream."""
        n = len(req.prompt)
        if self.prefill_chunk is not None and n > self.prefill_chunk:
            padded = round_up(n, self.prefill_chunk)
        else:
            padded = min(round_up(n, self.prefill_bucket), self.max_len)
        return max(padded, n + req.max_new_tokens)

    def _admit(self) -> None:
        """Move waiting requests into the prefill queue, reserving their
        full paged footprint up front (FIFO backpressure: the head of the
        queue blocks admission until its reservation fits).  With the
        prefix cache on, cached prompt pages are adopted (shared,
        refcounted) and prefill resumes at the first un-cached page."""
        while self.waiting and self.free_slots:
            req = self.waiting[0]
            slot = self.free_slots[0]
            matched = self._backend.try_admit(
                req, slot, self._reservation_tokens(req)
            )
            if matched is None:
                break
            self.waiting.pop(0)
            self.free_slots.pop(0)
            req.slot = slot
            if matched:
                req.prefill_pos = matched
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += matched
            self.prefilling.append(req)

    def _register_prefix(self, req: Request) -> None:
        if self.prefix_cache:
            self._backend.register_prefix(req)

    def _prefill_advance_group(self) -> None:
        """Advance prefill this step: the head request's next chunk, or —
        when several pending prompts bucket to the same padded width — ONE
        batched whole-prefill forward over all of them (multi-request
        batched prefill: k prompts cost one forward instead of k).

        Whole-batch groups are PIPELINED: this step's forward is submitted
        to the device first, and only then is the PREVIOUS group's
        first-token fetch resolved — the device-to-host copy overlaps the
        new group's compute instead of idling the card."""
        cand = [r for r in self.prefilling if not r.dispatched]
        if not cand:
            self._resolve_pending_prefill()
            return
        head = cand[0]

        def whole(r: Request) -> bool:
            # Prefix-matched requests (prefill_pos > 0) must resume at
            # their page-aligned offset — the whole path writes from 0.
            return r.prefill_pos == 0 and (
                self.prefill_chunk is None
                or len(r.prompt) <= self.prefill_chunk
            )

        def padded(r: Request) -> int:
            return min(
                round_up(len(r.prompt), self.prefill_bucket), self.max_len
            )

        if not whole(head):
            # Chunked path fetches its own final-chunk logits; resolve any
            # pending group first to preserve FIFO emission order.
            self._resolve_pending_prefill()
            self._prefill_advance(head)
            return
        group = [r for r in cand if whole(r) and padded(r) == padded(head)]
        # Bound the jit-program count: batch sizes are the largest power
        # of two <= len(group) (a fresh (k, padded) shape means a fresh
        # 30-240 s remote compile that stalls every live decode stream —
        # CLAUDE.md; padding with dummy rows instead would need a spare
        # slot to absorb their cache writes).  The remainder prefills next
        # step.  Cap the batch by TOKENS (k x padded <= 4096) and at 32
        # requests: the fused forward+append holds every layer's K/V plus
        # the donated caches live at once — 128 x 128-token and
        # 32 x 512-token batches both OOM'd a 16 GB chip at 8B shapes
        # (measured: model_grid.py slots128, serving_context_ladder.py).
        cap = min(32, max(1, 4096 // padded(head)), len(group))
        k = 1 << (cap.bit_length() - 1)  # power of two: bounded jit count
        pending = self._dispatch_whole_batch(group[:k], padded(head))
        # Resolve the PREVIOUS group only after this group's forward is
        # in the device queue — its fetch overlaps this group's compute.
        self._resolve_pending_prefill()
        self._pending_prefill = pending
        if not any(not r.dispatched for r in self.prefilling):
            # No further group to overlap with: resolve now (same-step
            # activation, the pre-pipelining semantics) — unless the
            # burst driver asked to defer so the fetch can ride behind
            # the first decode burst (_decode_burst_eager).
            if not getattr(self, "_defer_last_resolve", False):
                self._resolve_pending_prefill()

    def _dispatch_whole_batch(self, reqs: List[Request], padded: int):
        """Submit one batched prefill forward for same-bucket prompts plus
        the DEVICE-side first-token sampling; returns the pending tuple
        (reqs, device tokens, device logprob pack) for a deferred fetch.
        K/V scatter into every request's slot is a single batched ragged
        append inside the same dispatch.

        Prefill-throughput structure (each measured): the LM head runs on
        ONE row per request (last_pos — the full-sequence head is the
        biggest prefill matmul and all but B rows are discarded), all
        layers' cache appends go in ONE jitted dispatch, and all-greedy
        batches take their first tokens with ONE deferred device fetch."""
        k = len(reqs)
        tokens = np.zeros((k, padded), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : len(r.prompt)] = r.prompt
        # Forward + every cache write in ONE jitted dispatch (the separate
        # append dispatch was part of the measured engine prefill gap —
        # benchmarks/engine_prefill_probe.py).
        logits = self._backend.prefill_and_write(
            self._prefill_fn, self.params, jnp.asarray(tokens),
            [len(r.prompt) - 1 for r in reqs],
            [r.slot for r in reqs], [len(r.prompt) for r in reqs], padded,
        )
        for r in reqs:
            self._register_prefix(r)
            r.dispatched = True
        self.stats["prefill_forwards"] += 1
        # Sampling runs ON DEVICE here; only the resolve's np.asarray waits
        # for the device — once per group, overlapped with the next
        # group's forward.
        want_lp = any(r.logprobs for r in reqs)
        flps = None
        if len({r.sampling for r in reqs}) == 1:
            if want_lp:
                firsts, flps = self._sample_lp_dev(logits, reqs[0].sampling)
            else:
                firsts = self._sample(logits, reqs[0].sampling)
        elif want_lp:
            pairs = [
                self._sample_lp_dev(logits[i : i + 1], r.sampling)
                for i, r in enumerate(reqs)
            ]
            firsts = jnp.concatenate([t for t, _ in pairs])
            flps = jnp.concatenate([l for _, l in pairs])
        else:
            firsts = jnp.concatenate(
                [
                    self._sample(logits[i : i + 1], r.sampling)
                    for i, r in enumerate(reqs)
                ]
            )
        return (reqs, firsts, flps)

    def _resolve_pending_prefill(self) -> None:
        """Fetch a dispatched group's first tokens and finish its
        bookkeeping (emit, activate).  No-op when nothing is pending."""
        if self._pending_prefill is None:
            return
        reqs, firsts, flps = self._pending_prefill
        self._pending_prefill = None
        firsts = np.asarray(firsts)
        if flps is not None:
            flps = np.asarray(flps)
        for i, r in enumerate(reqs):
            if r.done or r not in self.prefilling:
                continue  # cancelled between dispatch and resolve
            self.prefilling.remove(r)
            r.prefill_pos = len(r.prompt)
            self.stats["prefill_tokens"] += len(r.prompt)
            lp = float(flps[i]) if flps is not None else None
            if not self._emit(r, int(firsts[i]), lp=lp):
                self.active[r.slot] = r

    def _prefill_advance(self, req: Request) -> None:
        """Advance a CHUNKED request's prefill by one chunk; when the
        prompt is fully in cache, sample the first token and promote the
        request to the decode set.  (Whole-prompt requests go through
        _prefill_whole_batch — one implementation of the write path.)"""
        n = len(req.prompt)
        logits_last = self._prefill_one_chunk(req)
        if req.prefill_pos < n:
            return  # more chunks to go; decode still runs this step
        self.prefilling.remove(req)
        self._register_prefix(req)
        if req.logprobs:
            t, l = self._sample_lp(logits_last, req.sampling)
            finished_now = self._emit(req, int(t[0]), lp=float(l[0]))
        else:
            first = self._sample(logits_last, req.sampling)
            finished_now = self._emit(req, int(first[0]))
        if not finished_now:  # may finish at prefill (max_new_tokens == 1)
            self.active[req.slot] = req

    def _prefill_one_chunk(self, req: Request) -> jax.Array:
        """Run exactly one prefill chunk for ``req``; returns the chunk's
        last-valid-position logits (meaningful only on the final chunk)."""
        n = len(req.prompt)
        off = req.prefill_pos
        chunk = self.prefill_chunk
        tc = min(chunk, n - off)
        tokens = np.zeros((1, chunk), np.int32)
        tokens[0, :tc] = req.prompt[off : off + tc]
        logits = self._backend.prefill_chunk(
            self.params, jnp.asarray(tokens), req, off, tc
        )
        req.prefill_pos = off + tc
        self.stats["prefill_tokens"] += tc
        self.stats["prefill_forwards"] += 1
        return logits[:, tc - 1, :]

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _active_mask(self) -> np.ndarray:
        mask = np.zeros((self.num_slots,), bool)
        for slot in self.active:
            mask[slot] = True
        return mask

    def _decode_burst(self, n: int) -> List[Request]:
        sp = next(iter(self.active.values())).sampling
        want_lp = any(r.logprobs for r in self.active.values())
        active_mask = self._active_mask()
        eos = np.full((self.num_slots,), -1, np.int32)
        remaining = np.zeros((self.num_slots,), np.int32)
        for slot, req in self.active.items():
            eos[slot] = -1 if req.eos_id is None else req.eos_id
            remaining[slot] = req.max_new_tokens - len(req.output)
        self._key, sub = jax.random.split(self._key)
        packed = self._backend.burst(
            self.params, self.last_token, active_mask, remaining, eos, sub,
            n, sp, want_lp,
        )
        return self._parse_burst_trace(packed, want_lp, n)

    def _eager_burst_size(self, decode_burst: Optional[int]) -> int:
        """Burst size when the only thing standing between a pure-decode
        phase and the pending LAST prefill group is its first-token
        fetch: > 1 means _decode_burst_eager can merge the group's
        device-resident first tokens into the burst's inputs on device
        and resolve the fetch AFTER the burst is submitted."""
        if not decode_burst or decode_burst <= 1:
            return 1
        if self.draft_params is not None:
            return 1
        if self.waiting or self._pending_prefill is None:
            return 1
        if any(not r.dispatched for r in self.prefilling):
            return 1  # more groups to dispatch: normal pipelining covers
        live = [
            r for r in self._pending_prefill[0]
            if not r.done and r in self.prefilling
        ]
        if not live:
            return 1
        allr = list(self.active.values()) + live
        if len({r.sampling for r in allr}) != 1:
            return 1
        n = decode_burst
        for r in self.active.values():
            n = min(n, r.max_new_tokens - len(r.output),
                    self.max_len - len(r.prompt) - len(r.output))
        for r in live:
            # The group's first token precedes the burst's steps.
            n = min(n, r.max_new_tokens - 1,
                    self.max_len - len(r.prompt) - 1)
        return max(n, 1)

    def _decode_burst_eager(self, n: int) -> List[Request]:
        """Overlap the LAST prefill group's first-token fetch with the
        first decode burst: the pending group's device-resident first
        tokens feed the burst's initial tokens via an on-device merge
        (EOS-struck / zero-budget pending slots deactivate on device,
        no host roundtrip), the burst is submitted, and only then is
        the group's long-since-computed fetch resolved — the
        device-to-host copy rides behind the burst's compute instead of
        idling the card."""
        reqs_p, firsts, flps = self._pending_prefill
        self._pending_prefill = None
        live = [
            (i, r) for i, r in enumerate(reqs_p)
            if not r.done and r in self.prefilling
        ]
        for _, r in live:
            self.prefilling.remove(r)
            r.prefill_pos = len(r.prompt)
            self.stats["prefill_tokens"] += len(r.prompt)
            self.active[r.slot] = r  # optimistic activation
        sp = next(iter(self.active.values())).sampling
        want_lp = any(r.logprobs for r in self.active.values())
        active_mask = self._active_mask()
        eos = np.full((self.num_slots,), -1, np.int32)
        remaining = np.zeros((self.num_slots,), np.int32)
        pend = {r.slot for _, r in live}
        for slot, req in self.active.items():
            eos[slot] = -1 if req.eos_id is None else req.eos_id
            remaining[slot] = req.max_new_tokens - len(req.output) - (
                1 if slot in pend else 0
            )
        if self._eager_merge_jit is None:

            def _merge(last, act, firsts, slots, eos, rem):
                last = last.at[slots].set(firsts.astype(last.dtype))
                hit = jnp.logical_and(last == eos, eos >= 0)
                ok = jnp.logical_and(rem > 0, ~hit)
                is_pend = jnp.zeros_like(act).at[slots].set(True)
                return last, jnp.where(is_pend, ok, act)

            self._eager_merge_jit = jax.jit(_merge)
        tokens_d, active_d = self._eager_merge_jit(
            jnp.asarray(self.last_token), jnp.asarray(active_mask),
            jnp.asarray(firsts).reshape(-1),
            jnp.asarray([r.slot for _, r in live], jnp.int32),
            jnp.asarray(eos), jnp.asarray(remaining),
        )
        self._key, sub = jax.random.split(self._key)
        packed = self._backend.burst(
            self.params, tokens_d, active_d, remaining, eos, sub, n, sp,
            want_lp, host_active=active_mask,
        )
        # The burst's fetch just completed, so the group's first tokens
        # (queued long before it) are free to read now.
        firsts_h = np.asarray(firsts).reshape(-1)
        flps_h = np.asarray(flps).reshape(-1) if flps is not None else None
        finished: List[Request] = []
        for i, r in live:
            lp = float(flps_h[i]) if flps_h is not None else None
            if self._emit(r, int(firsts_h[i]), lp=lp):
                finished.append(r)
        finished.extend(self._parse_burst_trace(packed, want_lp, n))
        return finished

    def _parse_burst_trace(self, packed, want_lp: bool, n: int):
        if want_lp:
            toks = packed[0].astype(np.int32)
            emits = packed[1] != 0.0
            lps = packed[2]
        else:
            toks, emits, lps = packed[0], packed[1].astype(bool), None
        self.stats["decode_steps"] += n
        finished: List[Request] = []
        # Per-SLOT emit loops over the burst trace: the naive
        # (step x slot) scan is n*num_slots python iterations per burst
        # (8k at 128 slots / burst 64) and scales the host gap between
        # bursts with the slot count.
        for slot, req in list(self.active.items()):
            col = emits[:, slot]
            if not col.any():
                continue
            for t in np.flatnonzero(col):
                lp = float(lps[t, slot]) if lps is not None else None
                if self._emit(req, int(toks[t, slot]), lp=lp):
                    finished.append(req)
                    break
        return finished

    def _decode(self) -> List[Request]:
        self.stats["decode_steps"] += 1
        if self.draft_params is not None:
            # A per-token step advances the TARGET cache only — any slot
            # it touches has a stale draft cache afterwards, and a later
            # speculative round must mirror-prefill it again (otherwise
            # rollback would mark never-written draft rows as valid).
            for slot in self.active:
                self._draft_prefilled.discard(slot)
        logits = self._backend.decode(
            self.params, self.last_token, self._active_mask(),
            list(self.active),
        )

        finished: List[Request] = []
        items = list(self.active.items())
        want_lp = any(req.logprobs for _, req in items)
        if len({req.sampling for _, req in items}) == 1:
            # One device op + ONE host fetch for all slots (a per-slot
            # sampling loop would wait for the device |active| times).
            # Rows of inactive slots are sampled too (same op) and ignored.
            sp = items[0][1].sampling
            if want_lp:
                toks, lps = self._sample_lp(logits, sp)
            else:
                toks, lps = np.asarray(self._sample(logits, sp)), None
            for slot, req in items:
                lp = float(lps[slot]) if lps is not None else None
                if self._emit(req, int(toks[slot]), lp=lp):
                    finished.append(req)
            return finished
        # Mixed per-request sampling params: sample per request.
        for slot, req in items:
            if req.logprobs:
                t, l = self._sample_lp(logits[slot : slot + 1], req.sampling)
                tok, lp = int(t[0]), float(l[0])
            else:
                tok = int(
                    self._sample(logits[slot : slot + 1], req.sampling)[0]
                )
                lp = None
            if self._emit(req, tok, lp=lp):
                finished.append(req)
        return finished

    # ------------------------------------------------------------------
    # Speculative decoding
    # ------------------------------------------------------------------

    def _draft_prefill(self, req: Request) -> None:
        """Mirror-prefill a request's context into the draft caches.

        Runs lazily at the first speculative round a slot participates in;
        the context is prompt + output[:-1] (the last emitted token is the
        pending next input, not yet in either cache)."""
        ctx = list(req.prompt) + req.output[:-1]
        n = len(ctx)
        padded = min(round_up(n, self.prefill_bucket), self.max_len)
        tokens = np.zeros((1, padded), np.int32)
        tokens[0, :n] = ctx
        # Forward + appends in one dispatch; last_pos keeps the (discarded)
        # LM head to one row instead of the whole padded sequence.
        self._draft_backend.prefill_and_write(
            self._draft_prefill_fn, self.draft_params, jnp.asarray(tokens),
            [n - 1], [req.slot], [n], padded,
        )

    def _spec_applicable(self) -> bool:
        """Speculative rounds need a draft, a SINGLE shared SamplingParams
        across active requests (greedy -> argmax acceptance; stochastic ->
        the rejection scheme in serving/speculative.py, which needs one
        filtered distribution per round), and cache room for the whole
        candidate block: the verification append writes spec_tokens+1 rows
        BEFORE acceptance, and a write that would cross max_len gets
        silently clamped by dynamic_update_slice (corrupting the cache
        tail) — near the end we fall back to per-token decoding."""
        if self.draft_params is None or not self.active:
            return False
        if len({r.sampling for r in self.active.values()}) != 1:
            return False
        if any(r.logprobs for r in self.active.values()):
            # Per-token logprob reporting needs the target distribution at
            # every position; the speculative acceptance path does not
            # retain it — such requests decode per-token/burst instead.
            return False
        room = self.spec_tokens + 1
        if not all(
            len(r.prompt) + len(r.output) - 1 + room <= self.max_len
            for r in self.active.values()
        ):
            return False
        # The paged backend must also be able to GROW every active slot by
        # the candidate block (verification may write past the admission
        # reservation when most of the new-token budget is already spent).
        return self._backend.can_speculate(list(self.active), room)

    def _speculative_round(self) -> List[Request]:
        """One speculative-decoding round over all active slots.

        The draft proposes ``spec_tokens`` tokens autoregressively (cheap);
        the target scores all of them in ONE parallel pass; acceptance is
        argmax equality for greedy requests, or the Leviathan rejection
        scheme (serving/speculative.py) for stochastic ones — either way
        the round emits 1..spec_tokens+1 tokens for exactly one target
        sweep over the KV stream, and the emitted stream is distributed
        exactly as plain decoding (bit-identical for greedy).
        """
        from .sampling import filtered_probs
        from .speculative import speculative_accept

        for slot, req in self.active.items():
            if slot not in self._draft_prefilled:
                self._draft_prefill(req)
                self._draft_prefilled.add(slot)
        gamma = self.spec_tokens
        self.stats["spec_rounds"] += 1
        sp0 = next(iter(self.active.values())).sampling  # shared (checked)
        greedy = sp0.temperature == 0.0
        active_np = self._active_mask()
        amask = jnp.asarray(active_np)

        # Draft proposes gamma tokens; one EXTRA step appends the last
        # proposal into the draft cache so an all-accepted round leaves the
        # draft with the full accepted prefix (rollback only ever shrinks).
        # Proposals stay ON DEVICE through the loop — a host fetch per
        # draft step would pay the fixed ~33 ms dispatch+fetch roundtrip
        # spec_tokens times per round (bench.py), swamping the speedup.
        cur = jnp.asarray(self.last_token)
        proposals = [cur]
        q_probs_steps = []
        for g in range(gamma + 1):
            dlogits = self._draft_backend.decode(
                self.draft_params, cur, active_np, list(self.active)
            )
            if g < gamma:
                if greedy:
                    cur = jnp.argmax(dlogits, axis=-1).astype(jnp.int32)
                else:
                    # Propose BY SAMPLING from the filtered draft dist —
                    # the rejection ratio p/q is only exact when proposals
                    # really come from the q it divides by (and sampling
                    # from the very q we stored costs one filtering pass,
                    # not two).
                    qp = filtered_probs(dlogits, sp0)
                    q_probs_steps.append(qp)
                    self._key, kg = jax.random.split(self._key)
                    cur = jax.random.categorical(
                        kg, jnp.log(jnp.maximum(qp, 1e-30)), axis=-1
                    ).astype(jnp.int32)
                proposals.append(cur)

        # Target scores [last_token, d_1..d_gamma] in one parallel pass.
        cand_dev = jnp.stack(proposals, axis=1)  # (num_slots, gamma+1)
        positions = self._backend.host_lengths()
        vlogits = self._backend.verify(
            self.params, cand_dev, positions, active_np
        )

        if greedy:
            tgt = np.asarray(jnp.argmax(vlogits, axis=-1).astype(jnp.int32))
        else:
            vocab = vlogits.shape[-1]
            p_probs = filtered_probs(
                vlogits.reshape(-1, vocab), sp0
            ).reshape(vlogits.shape)
            self._key, ka = jax.random.split(self._key)
            n_acc_d, final_d = speculative_accept(
                ka, jnp.stack(q_probs_steps, axis=1), p_probs,
                cand_dev[:, 1:],
            )
            n_acc_np = np.asarray(n_acc_d)
            final_np = np.asarray(final_d)
        # Host fetches happen HERE, once per round (greedy: tgt+cand;
        # stochastic: n_acc/final/cand) — never inside the draft loop.
        cand = np.asarray(cand_dev)

        finished: List[Request] = []
        new_len = positions.copy()
        rollback = np.zeros((self.num_slots,), bool)
        for slot, req in list(self.active.items()):
            done = False
            if greedy:
                n_acc = 0
                for i in range(gamma):
                    accepted = tgt[slot, i] == cand[slot, i + 1]
                    if accepted:
                        n_acc += 1
                    # Emit the target's token either way: on acceptance it
                    # equals the draft proposal; on mismatch it is the
                    # correction (and the round ends for this slot).
                    done = self._emit(req, int(tgt[slot, i]))
                    if done or not accepted:
                        break
                else:
                    if not done:
                        done = self._emit(req, int(tgt[slot, gamma]))
            else:
                n_acc = int(n_acc_np[slot])
                for i in range(n_acc):
                    done = self._emit(req, int(cand[slot, i + 1]))
                    if done:
                        break
                if not done:
                    done = self._emit(req, int(final_np[slot]))
            if done:
                finished.append(req)
            self.stats["spec_proposed"] += gamma
            self.stats["spec_accepted"] += n_acc
            new_len[slot] = positions[slot] + 1 + n_acc
            # Finished slots were freed by _maybe_finish (lengths zeroed);
            # don't resurrect them.
            rollback[slot] = not done

        self._backend.rollback(rollback, new_len)
        self._draft_backend.rollback(rollback, new_len)
        return finished

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------

    def _emit(
        self, req: Request, tok: int, lp: Optional[float] = None
    ) -> bool:
        """Record a newly sampled token: append, remember it as the slot's
        next decode input, stream it to the request's callback, and check
        termination.  Returns True when the request finished."""
        req.output.append(tok)
        if req.logprobs:
            req.logprob_output.append(
                float(lp) if lp is not None else float("nan")
            )
        self.stats["generated_tokens"] += 1
        if req.slot is not None:
            self.last_token[req.slot] = tok
        if req.on_token is not None:
            req.on_token(tok, req)
        return self._maybe_finish(req, tok)

    def _sample(self, logits: jax.Array, sp: SamplingParams) -> jax.Array:
        if sp.temperature == 0.0:
            return sample(logits, sp)
        self._key, sub = jax.random.split(self._key)
        return sample(logits, sp, sub)

    def _sample_lp_dev(self, logits: jax.Array, sp: SamplingParams):
        """Sample rows AND their logprobs, both left ON DEVICE (the
        caller decides when to pay the fetch)."""
        key = None
        if sp.temperature > 0.0:
            self._key, key = jax.random.split(self._key)
        return sample_with_logprob(logits, sp, key)

    def _sample_lp(self, logits: jax.Array, sp: SamplingParams):
        """Sample rows AND their logprobs; ships both to the host in ONE
        packed device-to-host copy.
        Token ids round-trip exactly through float32 (vocab < 2^24)."""
        toks, lps = self._sample_lp_dev(logits, sp)
        packed = np.asarray(jnp.stack([toks.astype(jnp.float32), lps]))
        return packed[0].astype(np.int32), packed[1]

    def _maybe_finish(self, req: Request, tok: int) -> bool:
        hit_eos = req.eos_id is not None and tok == req.eos_id
        exhausted = len(req.output) >= req.max_new_tokens
        total = len(req.prompt) + len(req.output)
        if hit_eos or exhausted or total >= self.max_len:
            self._release(req)
            return True
        return False

    def _release(self, req: Request) -> None:
        """Mark ``req`` done and return its slot (cache rows, pages) to the
        pool."""
        req.done = True
        if req.slot is not None and req.slot in self.active:
            del self.active[req.slot]
        if req.slot is not None:
            self._backend.release(req.slot)
            if self.draft_params is not None:
                self._draft_backend.release(req.slot)
                self._draft_prefilled.discard(req.slot)
            self.free_slots.append(req.slot)
        self.finished.append(req)

    def cancel(self, req: Request) -> None:
        """Abort a request at any stage: waiting requests are dropped from
        the queue; prefilling/active ones release their slot (and paged
        reservation) immediately.  Already-generated tokens stay in
        ``req.output``; ``req.done`` is set either way."""
        if req.done:
            return
        if req in self.waiting:
            self.waiting.remove(req)
            req.done = True
            self.finished.append(req)
            return
        if req in self.prefilling:
            self.prefilling.remove(req)
        self._release(req)
