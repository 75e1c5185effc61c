"""Fused flash-attention forward kernel (Pallas through Triton, for Hopper).

The reference's two hot kernels are a ThunderKittens warp-specialised TMA
pipeline (reference: src/quantum_attn/tk/attention.py:97-349) and a Triton
persistent TMA template (reference: inductor/kernels/attention.py:147-670).
This kernel takes the reference's design through Pallas' Triton route:

  * grid ``(cdiv(Sq, block_q), Hq, B)`` (reference tk/attention.py:502-504);
    each program owns one Q tile and walks its KV tiles in an in-kernel
    loop, with Triton pipelining the K/V loads (``num_stages``);
  * QK^T on fp8 e4m3 operands with fp32 accumulation when the card has fp8
    tensor cores (CC >= 9.0; reference fp8 WGMMA, tk/attention.py:233),
    PV in bf16;
  * ``scale_q * scale_k * sm_scale * log2(e)`` folded into one multiply
    and an exp2 online softmax (reference tk/attention.py:204-210,238-240);
  * masking only on the KV tiles that need it: the loop is split into
    unmasked interior tiles and masked edge tiles (causal diagonal,
    window edges, ragged tail) — the reference's causal two-stage
    decomposition (inductor/kernels/attention.py:592-641);
  * per-block fp8 quantization computed per tile inside the loop; a
    block-sparse mask is a per-Q-tile list of active KV tiles that each
    program reads itself.

Capabilities beyond the reference: GQA, sliding windows, position offsets
for ring/sequence-parallel composition, segment ids, block-sparse masks,
and residual (m, l) outputs for cross-device online-softmax merging.
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import config
from ..utils import checks
from ..utils.shapes import round_up

LOG2E = math.log2(math.e)

#: Large negative logit for masked positions; avoids NaN from (-inf) - (-inf)
#: while still flushing exp2/exp to exactly 0.
MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

#: Granule (in tokens, both axes) of the block-sparse attention bitmap.
#: Fixed so mask semantics do not depend on kernel tile sizes.
MASK_GRANULE = 128

#: Largest head dim the kernel tiles (a 128 x 256 fp32 accumulator is the
#: register budget of two warpgroups).
MAX_HEAD_DIM = 256

#: Largest magnitude of float8_e4m3fn, the per-block quantization target.
FP8_MAX = 448.0


class Tiles(NamedTuple):
    block_q: int
    block_kv: int
    num_warps: int
    num_stages: int


def default_tiles(head_dim: int) -> Tuple[int, int, int]:
    """(block_q, block_kv, num_warps) per head dim, after the reference's
    Hopper design (SURVEY.md: 64-row Q tiles per consumer warpgroup, KV
    tiles of 128 rows, 64 at D = 256)."""
    if head_dim <= 64:
        return 128, 128, 4
    if head_dim <= 128:
        return 128, 128, 8
    return 128, 64, 8


def choose_tiles(
    head_dim: int,
    q_bytes: int,
    kv_bytes: int,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
) -> Tiles:
    """Tiles for one call: the per-head-dim default, or the caller's
    blocks, with the deepest K/V pipeline the shared-memory fit model
    (``autotune.smem_fits``) admits.  Raises when even one stage does not
    fit one block's shared memory."""
    from .. import autotune

    bq_d, bkv_d, warps = default_tiles(head_dim)
    bq = block_q or config.kernel.block_q or bq_d
    bkv = block_kv or config.kernel.block_kv or bkv_d
    for b in (bq, bkv):
        if b < 16 or b & (b - 1):
            raise ValueError(f"block sizes must be powers of two >= 16, got {b}")
    for stages in (3, 2, 1):
        if autotune.smem_fits(bq, bkv, head_dim, q_bytes, kv_bytes, stages):
            return Tiles(bq, bkv, warps, stages)
    raise ValueError(
        f"tiles ({bq}, {bkv}) at head_dim {head_dim} exceed one block's "
        f"shared memory ({autotune.SMEM_BYTES} bytes)"
    )


class _Spec(NamedTuple):
    """Static configuration of one kernel instantiation."""

    scaling: str  # "none" | "head" | "token" | "block"
    causal: bool
    window: Optional[Tuple[Optional[int], Optional[int]]]
    base: float  # multiply on the raw QK product (1.0 when q is prescaled)
    kv_valid: int
    block_q: int
    block_kv: int
    num_kv_blocks: int
    has_offsets: bool
    has_segments: bool
    has_block_mask: bool
    dot_dtype: Any  # operand dtype of QK^T (None: keep q/k dtypes)
    int_dot: bool  # int8 x int8 -> int32 QK^T
    pv_dtype: Any
    has_scale_v: bool
    use_exp2: bool
    softmax_bf16: bool
    two_stage: bool
    return_residuals: bool


def _flash_kernel(*refs, spec: _Spec):
    refs = list(refs)
    q_ref, k_ref, v_ref = refs[:3]
    idx = 3
    if spec.scaling == "head":
        hs_ref = refs[idx]
        idx += 1
    elif spec.scaling == "token":
        sq_ref, sk_ref = refs[idx : idx + 2]
        idx += 2
    if spec.has_scale_v:
        sv_ref = refs[idx]
        idx += 1
    if spec.has_offsets:
        off_ref = refs[idx]
        idx += 1
    if spec.has_segments:
        qseg_ref, kvseg_ref = refs[idx : idx + 2]
        idx += 2
    if spec.has_block_mask:
        cnt_ref, jmap_ref = refs[idx : idx + 2]
        idx += 2
    o_ref = refs[idx]
    if spec.return_residuals:
        m_ref, l_ref = refs[idx + 1 : idx + 3]

    bq, bkv = spec.block_q, spec.block_kv
    i = pl.program_id(0)
    q_off = off_ref[0] if spec.has_offsets else 0
    kv_off = off_ref[1] if spec.has_offsets else 0
    q_min = q_off + i * bq
    rows = q_min + lax.broadcasted_iota(jnp.int32, (bq, bkv), 0)

    q = q_ref[...]
    q_scale = None
    if spec.scaling == "block":
        # Per-block dynamic quantization of the Q tile, once per program.
        qf = q.astype(jnp.float32)
        q_scale = jnp.maximum(jnp.max(jnp.abs(qf)) / FP8_MAX, 1e-12)
        q = (qf * (1.0 / q_scale)).astype(jnp.float8_e4m3fn)
    if spec.dot_dtype is not None:
        q = q.astype(spec.dot_dtype)
    if spec.scaling == "token":
        q_tok = sq_ref[...].astype(jnp.float32)[:, None] * spec.base
    if spec.has_segments:
        q_seg = qseg_ref[...][:, None]
    if spec.has_scale_v:
        sv = sv_ref[...].astype(jnp.float32)[None, :]
    exp = jnp.exp2 if spec.use_exp2 else jnp.exp

    def tile(j, carry, masked):
        acc, m_prev, l_prev = carry
        kv_slice = pl.ds(j * bkv, bkv)
        k = k_ref[kv_slice, :]
        if spec.scaling == "block":
            kf = k.astype(jnp.float32)
            k_scale = jnp.maximum(jnp.max(jnp.abs(kf)) / FP8_MAX, 1e-12)
            k = (kf * (1.0 / k_scale)).astype(jnp.float8_e4m3fn)
        if spec.dot_dtype is not None:
            k = k.astype(spec.dot_dtype)
        s = lax.dot_general(
            q, k, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32 if spec.int_dot else jnp.float32,
        ).astype(jnp.float32)
        if spec.scaling == "block":
            s = s * (q_scale * k_scale * spec.base)
        elif spec.scaling == "head":
            s = s * (hs_ref[...] * spec.base)
        elif spec.scaling == "token":
            s = s * q_tok * sk_ref[kv_slice].astype(jnp.float32)[None, :]
        elif spec.base != 1.0:
            s = s * spec.base
        if masked:
            local = j * bkv + lax.broadcasted_iota(jnp.int32, (bq, bkv), 1)
            cols = kv_off + local
            keep = local < spec.kv_valid
            if spec.causal:
                keep &= cols <= rows
            if spec.window is not None:
                left, right = spec.window
                if left is not None:
                    keep &= cols >= rows - left
                # Right extents are inactive under causal masking (kept in
                # sync with the loop bounds and the oracle VJP).
                if right is not None and not spec.causal:
                    keep &= cols <= rows + right
            if spec.has_segments:
                keep &= q_seg == kvseg_ref[kv_slice][None, :]
            s = jnp.where(keep, s, MASK_VALUE)
        m_next = jnp.maximum(m_prev, jnp.max(s, axis=1))
        alpha = exp(m_prev - m_next)
        p = exp(s - m_next[:, None])
        if spec.softmax_bf16:
            p = p.astype(jnp.bfloat16).astype(jnp.float32)
        l_next = alpha * l_prev + jnp.sum(p, axis=1)
        v = v_ref[kv_slice, :]
        if spec.has_scale_v:
            v = v.astype(jnp.float32) * sv
        pv = lax.dot_general(
            p.astype(spec.pv_dtype), v.astype(spec.pv_dtype),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
        )
        return acc * alpha[:, None] + pv, m_next, l_next

    head_dim = q_ref.shape[-1]
    carry = (
        jnp.zeros((bq, head_dim), jnp.float32),
        jnp.full((bq,), -jnp.inf, jnp.float32),
        jnp.zeros((bq,), jnp.float32),
    )
    masked = functools.partial(tile, masked=True)
    clean = functools.partial(tile, masked=False)
    if spec.has_block_mask:
        # Active KV tiles of this Q tile, listed by the wrapper.
        carry = lax.fori_loop(
            0, cnt_ref[...], lambda s, c: masked(jmap_ref[s], c), carry
        )
    else:
        lo, lo_clean, hi_clean, hi = _tile_bounds(spec, q_min, kv_off)
        if spec.two_stage:
            carry = lax.fori_loop(lo, lo_clean, masked, carry)
            carry = lax.fori_loop(lo_clean, hi_clean, clean, carry)
            carry = lax.fori_loop(hi_clean, hi, masked, carry)
        else:
            carry = lax.fori_loop(lo, hi, masked, carry)
    acc, m_i, l_i = carry

    o = acc * jnp.where(l_i == 0.0, 0.0, 1.0 / l_i)[:, None]
    # A row whose every KV position was masked never sees a logit above
    # MASK_VALUE; such rows are defined to output zeros.
    o = jnp.where((m_i > 0.5 * MASK_VALUE)[:, None], o, 0.0)
    o_ref[...] = o.astype(o_ref.dtype)
    if spec.return_residuals:
        m_ref[...] = m_i
        l_ref[...] = l_i


def _cdiv_nonneg(x, d: int):
    """ceil(x / d) for x that may be negative (clamped to 0)."""
    return lax.div(jnp.maximum(x, 0) + (d - 1), d)


def _floor_div_plus1(x, d: int):
    """floor(x / d) + 1 for any int32 x, clamped below at 0."""
    return jnp.where(x < 0, 0, lax.div(jnp.maximum(x, 0), d) + 1)


def _tile_bounds(spec: _Spec, q_min, kv_off):
    """KV tile ranges [lo, hi) that can contribute to this Q tile, and the
    interior [lo_clean, hi_clean) whose tiles need no mask at all."""
    bq, bkv, n = spec.block_q, spec.block_kv, spec.num_kv_blocks
    q_max = q_min + bq - 1
    # Tiles past the valid KV length never run; the tile holding the
    # ragged tail is an edge tile.
    lo = jnp.int32(0)
    hi = jnp.int32(-(-spec.kv_valid // bkv))
    lo_clean = lo
    hi_clean = jnp.int32(spec.kv_valid // bkv)
    left, right = spec.window if spec.window is not None else (None, None)
    if spec.causal:
        right = 0
    if right is not None:
        # Last tile with a column <= q_max + right; clean while every
        # column <= q_min + right.
        hi = jnp.minimum(hi, _floor_div_plus1(q_max + right - kv_off, bkv))
        hi_clean = jnp.minimum(
            hi_clean, _floor_div_plus1(q_min + right - kv_off - bkv + 1, bkv)
        )
    if left is not None:
        # First tile with a column >= q_min - left; clean once every
        # column >= q_max - left.
        lo = jnp.maximum(lo, _cdiv_nonneg(q_min - left - kv_off - bkv + 1, bkv))
        lo_clean = jnp.maximum(lo_clean, _cdiv_nonneg(q_max - left - kv_off, bkv))
    hi = jnp.clip(hi, 0, n)
    lo = jnp.minimum(lo, hi)
    lo_clean = jnp.clip(lo_clean, lo, hi)
    hi_clean = jnp.clip(hi_clean, lo_clean, hi)
    return lo, lo_clean, hi_clean, hi


def _block_mask_tables(block_mask, q_len, kv_len, q_len_p, kv_len_p, bq, bkv,
                       is_causal):
    """(count, list) of active KV tiles per Q tile of a granule bitmap.

    Traced or concrete masks take the same path: ``jmap[i]`` lists the
    active KV tile indices of Q tile ``i`` in ascending order (padding
    repeats after ``cnt[i]`` are never read)."""
    g = MASK_GRANULE
    expected = (-(-q_len // g), -(-kv_len // g))
    bm = jnp.asarray(block_mask)
    if bm.shape != expected:
        raise ValueError(
            f"block_mask must be (ceil(Sq/{g}), ceil(Skv/{g})) = "
            f"{expected}, got {bm.shape}"
        )
    n_q, n_kv = q_len_p // bq, kv_len_p // bkv
    rows = (jnp.arange(n_q) * bq) // g
    cols = (jnp.arange(n_kv) * bkv) // g
    act = bm.astype(jnp.int32)[rows][:, cols] > 0
    jj = jnp.arange(n_kv)[None, :]
    ii = jnp.arange(n_q)[:, None]
    act &= jj * bkv < kv_len
    if is_causal:
        act &= jj * bkv <= ii * bq + bq - 1
    cnt = act.sum(axis=1).astype(jnp.int32)
    jmap = jnp.argsort(jnp.where(act, 0, 1), axis=1, stable=True)
    return cnt, jmap.astype(jnp.int32)


def flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    scale_q: Optional[jax.Array] = None,
    scale_k: Optional[jax.Array] = None,
    scale_v: Optional[jax.Array] = None,
    fused_block_quant: bool = False,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    window: Optional[Tuple[Optional[int], Optional[int]]] = None,
    q_offset: Optional[jax.Array] = None,
    kv_offset: Optional[jax.Array] = None,
    q_segment_ids: Optional[jax.Array] = None,
    kv_segment_ids: Optional[jax.Array] = None,
    block_mask: Optional[jax.Array] = None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    return_residuals: bool = False,
    interpret: Optional[bool] = None,
):
    """Fused attention forward over (B, H, S, D) tensors.

    Args:
      q: (B, Hq, Sq, D); bf16/fp16/fp32, fp8 e4m3, or int8 (with scales).
      k: (B, Hkv, Skv, D); same dtype family as q. Hq % Hkv == 0 (GQA).
      v: (B, Hkv, Skv, D); bf16/fp16/fp32 or fp8 e4m3, or int8 with
        per-channel ``scale_v`` (B, Hkv, D).
      scale_q/scale_k: dequantization scales; (B, H) = head-wise or
        (B, H, S) = token-wise (reference nn.py:410-418). Both or neither.
      fused_block_quant: quantize float q/k to e4m3 per (Q tile, KV tile)
        inside the kernel.
      is_causal: lower-triangular masking.
      sm_scale: softmax scale; defaults to 1/sqrt(D).
      window: optional (left, right) sliding-window extents.
      q_offset/kv_offset: optional int32 scalars giving the global position
        of row/col 0 — used by ring/sequence-parallel attention to keep
        causal masks correct as KV blocks rotate between cards.
      q_segment_ids/kv_segment_ids: (B, Sq)/(B, Skv) packed-document ids.
      block_mask: (ceil(Sq/128), ceil(Skv/128)) granule bitmap.
      block_q/block_kv: tile sizes (powers of two); default per head dim.
      return_residuals: also return the online-softmax stats (m, l), each
        (B, Hq, Sq) fp32, m in the exp2 domain.

    Returns:
      out with q's (B, Hq, Sq, D) shape in v's float dtype (bf16 for 8-bit
      v), and (m, l) when return_residuals.
    """
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    if num_q_heads % num_kv_heads != 0:
        raise ValueError("num_q_heads must be divisible by num_kv_heads")
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {head_dim} > {MAX_HEAD_DIM}: exceeds the kernel's "
            "register tile (dispatch routes such calls to the XLA path)"
        )
    group = num_q_heads // num_kv_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    if interpret is None:
        interpret = checks.resolve_interpret(config.interpret)

    if (scale_q is None) != (scale_k is None):
        raise ValueError("scale_q and scale_k must be given together")
    if fused_block_quant:
        if scale_q is not None:
            raise ValueError(
                "fused_block_quant quantizes in-kernel; do not pass scales"
            )
        if checks.is_8bit_dtype(q.dtype) or checks.is_8bit_dtype(k.dtype):
            raise ValueError("fused_block_quant expects float q/k")
        scaling = "block"
    elif scale_q is None:
        scaling = "none"
    elif scale_q.ndim == 2:
        scaling = "head"
    elif scale_q.ndim == 3:
        scaling = "token"
    else:
        raise ValueError(f"bad scale rank: {scale_q.ndim}")
    if q.dtype == jnp.int8 and scaling == "none":
        raise ValueError("int8 q/k require scales")
    if v.dtype == jnp.int8 and scale_v is None:
        raise ValueError("int8 v requires per-channel scale_v (B, Hkv, D)")
    if scale_v is not None and scale_v.shape != (
        v.shape[0], v.shape[1], v.shape[3],
    ):
        raise ValueError(f"scale_v must be (B, Hkv, D), got {scale_v.shape}")
    has_segments = q_segment_ids is not None or kv_segment_ids is not None
    if has_segments:
        if q_segment_ids is None or kv_segment_ids is None:
            raise ValueError("both q/kv segment ids must be provided")
        if q_segment_ids.shape != (batch, q_len) or kv_segment_ids.shape != (
            batch, kv_len,
        ):
            raise ValueError(
                "segment ids must be (B, Sq) / (B, Skv), got "
                f"{q_segment_ids.shape} / {kv_segment_ids.shape}"
            )
    has_offsets = q_offset is not None or kv_offset is not None
    if block_mask is not None and has_offsets:
        raise ValueError("block_mask with ring position offsets is not supported")

    # QK^T operand dtype: fp8 e4m3 straight into the tensor cores where
    # the card has them (CC >= 9.0), int8 x int8 -> int32 for int8
    # operands, otherwise an exact upcast to bf16 (e4m3 and int8 embed
    # exactly in bf16, and the fp32 accumulation is unchanged).
    fp8_native = checks.fp8_dot_enabled()
    int_dot = (
        q.dtype == jnp.int8 and k.dtype == jnp.int8
        and config.attention.enable_int8_qk
    )
    if scaling == "block":
        dot_dtype = None if fp8_native else jnp.bfloat16
    elif int_dot:
        dot_dtype = None
    elif checks.is_8bit_dtype(q.dtype) or checks.is_8bit_dtype(k.dtype):
        both_fp8 = checks.is_fp8_dtype(q.dtype) and checks.is_fp8_dtype(k.dtype)
        dot_dtype = None if (both_fp8 and fp8_native) else jnp.bfloat16
    elif q.dtype != k.dtype:
        dot_dtype = jnp.promote_types(q.dtype, k.dtype)
    else:
        dot_dtype = None
    out_dtype = jnp.bfloat16 if checks.is_8bit_dtype(v.dtype) else v.dtype
    pv_dtype = (
        jnp.float32 if out_dtype == jnp.float32
        else jnp.float16 if out_dtype == jnp.float16
        else jnp.bfloat16
    )

    head_dim_p = max(16, pl.next_power_of_2(head_dim))
    k_bytes = 1 if scaling == "block" else k.dtype.itemsize
    tiles = choose_tiles(
        head_dim_p, q.dtype.itemsize, max(k_bytes, v.dtype.itemsize),
        block_q, block_kv,
    )
    bq, bkv = tiles.block_q, tiles.block_kv
    if block_mask is not None:
        # Tiles no larger than the mask granule, so each tile is either
        # wholly active or wholly skipped.
        bq, bkv = min(bq, MASK_GRANULE), min(bkv, MASK_GRANULE)
    bq = min(bq, max(16, pl.next_power_of_2(q_len)))
    bkv = min(bkv, max(16, pl.next_power_of_2(kv_len)))

    # Fold sm_scale (and the exp2-domain log2(e)) into float q without
    # dequant scales: one elementwise pass XLA fuses with the producer,
    # instead of a multiply over every score tile.
    log_base = LOG2E if config.kernel.use_exp2 else 1.0
    base = sm_scale * log_base
    if scaling == "none" and not checks.is_8bit_dtype(q.dtype):
        q = q * jnp.asarray(base, q.dtype)
        base = 1.0

    q_len_p = round_up(q_len, bq)
    kv_len_p = round_up(kv_len, bkv)

    def pad(t, seq_target, seq_axis=2, dim_axis=3):
        widths = [(0, 0)] * t.ndim
        widths[seq_axis] = (0, seq_target - t.shape[seq_axis])
        if dim_axis is not None:
            widths[dim_axis] = (0, head_dim_p - t.shape[dim_axis])
        return jnp.pad(t, widths) if any(w != (0, 0) for w in widths) else t

    qp = pad(q, q_len_p)
    kp = pad(k, kv_len_p)
    vp = pad(v, kv_len_p)

    def kv_head(h):
        return lax.div(h, group) if group > 1 else h

    grid = (q_len_p // bq, num_q_heads, batch)
    in_specs = [
        pl.BlockSpec((None, None, bq, head_dim_p), lambda i, h, b: (b, h, i, 0)),
        pl.BlockSpec(
            (None, None, kv_len_p, head_dim_p),
            lambda i, h, b: (b, kv_head(h), 0, 0),
        ),
        pl.BlockSpec(
            (None, None, kv_len_p, head_dim_p),
            lambda i, h, b: (b, kv_head(h), 0, 0),
        ),
    ]
    args = [qp, kp, vp]
    if scaling == "head":
        # One scalar per (b, h): both dequant scales multiplied up front.
        kv_idx = jnp.arange(num_q_heads) // group
        hs = scale_q.astype(jnp.float32) * scale_k.astype(jnp.float32)[:, kv_idx]
        in_specs.append(pl.BlockSpec((None, None), lambda i, h, b: (b, h)))
        args.append(hs)
    elif scaling == "token":
        in_specs += [
            pl.BlockSpec((None, None, bq), lambda i, h, b: (b, h, i)),
            pl.BlockSpec(
                (None, None, kv_len_p), lambda i, h, b: (b, kv_head(h), 0)
            ),
        ]
        args += [
            pad(scale_q.astype(jnp.float32), q_len_p, dim_axis=None),
            pad(scale_k.astype(jnp.float32), kv_len_p, dim_axis=None),
        ]
    if scale_v is not None:
        in_specs.append(
            pl.BlockSpec((None, None, head_dim_p), lambda i, h, b: (b, kv_head(h), 0))
        )
        args.append(pad(scale_v.astype(jnp.float32), scale_v.shape[1],
                        seq_axis=1, dim_axis=2))
    if has_offsets:
        offs = jnp.stack([
            jnp.asarray(0 if q_offset is None else q_offset, jnp.int32),
            jnp.asarray(0 if kv_offset is None else kv_offset, jnp.int32),
        ])
        in_specs.append(pl.BlockSpec((2,), lambda i, h, b: (0,)))
        args.append(offs)
    if has_segments:
        qseg = jnp.pad(q_segment_ids.astype(jnp.int32),
                       [(0, 0), (0, q_len_p - q_len)], constant_values=-1)
        kvseg = jnp.pad(kv_segment_ids.astype(jnp.int32),
                        [(0, 0), (0, kv_len_p - kv_len)], constant_values=-2)
        in_specs += [
            pl.BlockSpec((None, bq), lambda i, h, b: (b, i)),
            pl.BlockSpec((None, kv_len_p), lambda i, h, b: (b, 0)),
        ]
        args += [qseg, kvseg]
    if block_mask is not None:
        cnt, jmap = _block_mask_tables(
            block_mask, q_len, kv_len, q_len_p, kv_len_p, bq, bkv, is_causal
        )
        in_specs += [
            pl.BlockSpec((None,), lambda i, h, b: (i,)),
            pl.BlockSpec((None, jmap.shape[1]), lambda i, h, b: (i, 0)),
        ]
        args += [cnt, jmap]

    out_shape = [
        jax.ShapeDtypeStruct((batch, num_q_heads, q_len_p, head_dim_p), out_dtype)
    ]
    out_specs = [
        pl.BlockSpec((None, None, bq, head_dim_p), lambda i, h, b: (b, h, i, 0))
    ]
    if return_residuals:
        res = jax.ShapeDtypeStruct((batch, num_q_heads, q_len_p), jnp.float32)
        res_spec = pl.BlockSpec((None, None, bq), lambda i, h, b: (b, h, i))
        out_shape += [res, res]
        out_specs += [res_spec, res_spec]

    spec = _Spec(
        scaling=scaling,
        causal=is_causal,
        window=window,
        base=float(base),
        kv_valid=kv_len,
        block_q=bq,
        block_kv=bkv,
        num_kv_blocks=kv_len_p // bkv,
        has_offsets=has_offsets,
        has_segments=has_segments,
        has_block_mask=block_mask is not None,
        dot_dtype=dot_dtype,
        int_dot=int_dot,
        pv_dtype=pv_dtype,
        has_scale_v=scale_v is not None,
        use_exp2=bool(config.kernel.use_exp2),
        softmax_bf16=bool(config.kernel.softmax_bf16),
        two_stage=bool(config.kernel.causal_two_stage) and not has_segments,
        return_residuals=return_residuals,
    )
    flops = 4 * batch * num_q_heads * q_len_p * kv_len_p * head_dim_p
    outs = pl.pallas_call(
        functools.partial(_flash_kernel, spec=spec),
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=tiles.num_warps, num_stages=tiles.num_stages
        ),
        cost_estimate=pl.CostEstimate(
            flops=flops // 2 if is_causal else flops,
            bytes_accessed=sum(t.size * t.dtype.itemsize for t in (qp, kp, vp)),
            transcendentals=batch * num_q_heads * q_len_p * kv_len_p,
        ),
        interpret=interpret,
        name="qa_flash_fwd",
    )(*args)

    out = outs[0][:, :, :q_len, :head_dim]
    if return_residuals:
        return out, (outs[1][:, :, :q_len], outs[2][:, :, :q_len])
    return out
