"""Split k-mer window extraction as a data-parallel device kernel.

Replaces the reference's sequential rolling iterator
(src/ska_dict/split_kmer.rs:159-217) with an all-windows-at-once
formulation: packed flank values for every window start are built with
O(log k) shift/OR doubling passes, validity/emission masks come from
cumulative sums, and canonicalization (min of forward/reverse-complement,
split_kmer.rs:281-295) is elementwise. Everything is fixed-shape and
jit-compiled; window start index is the array index.

Emission semantics reproduced exactly (see split_kmer.rs:78-140 `build`
and :159-217 `roll_fwd`):
- a window is emitted iff all k bases are valid (not N/n; in Strict mode
  also quality > min_qual, :99-100,167-168)
- the final window of a record (ending on its last base) is only reachable
  by rolling, never by a fresh build (`idx + k >= seq_len`, :89), so it is
  additionally conditioned on the previous base being valid.
"""

from functools import partial

from ..jaxinit import jax, jnp
import numpy as np

from . import keys as K

U64 = jnp.uint64


def _shift_left_arr(a, s: int):
    """a[i] <- a[i+s], zero-padded at the end. Static s."""
    if s == 0:
        return a
    pad = [(0, s)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a[s:], pad)


def window_all(valid, n: int):
    """out[i] = AND of valid[i..i+n) (False out of range), via O(log n)
    shift-doubling passes (static shifts only: no gathers or scans)."""
    cur = valid
    cur_len = 1
    acc = None
    acc_len = 0
    nn = n
    while nn:
        if nn & 1:
            if acc is None:
                acc, acc_len = cur, cur_len
            else:
                shifted = jnp.concatenate(
                    [cur[acc_len:], jnp.zeros(acc_len, dtype=bool)]
                )
                acc = acc & shifted
                acc_len += cur_len
        nn >>= 1
        if nn:
            shifted = jnp.concatenate([cur[cur_len:], jnp.zeros(cur_len, dtype=bool)])
            cur = cur & shifted
            cur_len *= 2
    return acc if acc is not None else jnp.ones_like(valid)


def pack_n(codes_limbs, n: int):
    """codes_limbs: (L, W) uint64 with the 2-bit code in the low bits.

    Returns P: (L, W) where P[i] = bases i..i+n packed big-endian-by-base
    (first base in the highest 2-bit group), zero-filled out of range.
    O(log n) doubling passes.
    """
    cur = codes_limbs
    cur_len = 1
    acc = None
    acc_len = 0
    nn = n
    while nn:
        if nn & 1:
            if acc is None:
                acc = cur
                acc_len = cur_len
            else:
                acc = K.shl(acc, 2 * cur_len) | _shift_left_arr(cur, acc_len)
                acc_len += cur_len
        nn >>= 1
        if nn:
            cur = K.shl(cur, 2 * cur_len) | _shift_left_arr(cur, cur_len)
            cur_len *= 2
    return acc if acc is not None else jnp.zeros_like(codes_limbs)


@partial(jax.jit, static_argnames=("k", "rc", "W", "want_whole", "from_codes"))
def extract_windows(seq, valid, rec_last, k: int, rc: bool, W: int,
                    want_whole: bool = False, from_codes: bool = False):
    """All split k-mer windows of a flat record-batch.

    seq: uint8[L] ASCII (or 2-bit codes when from_codes=True — the
    packed-transfer path unpacks link bytes to codes on device, see
    pipeline.unpack_codes); valid: bool[L] (base validity incl.
    strict-qual); rec_last: bool[L] marks each record's final base.

    Returns dict with per-window-start arrays (length L):
      key   (L, W) canonical packed split k-mer
      mid   uint8[L] 2-bit middle base code (canonical orientation)
      is_rc bool[L] canonical is the reverse complement
      pal   bool[L] key is its own reverse complement
      emit  bool[L] window emitted
      whole (L, W) canonical packed whole k-mer (if want_whole)
    """
    L = seq.shape[0]
    h = (k - 1) // 2

    codes = seq.astype(U64) if from_codes else ((seq >> 1) & 0x3).astype(U64)
    codes_limbs = jnp.zeros((L, W), dtype=U64).at[:, W - 1].set(codes)

    # windowed all-valid + in-range, all via static shifts (no gathers)
    idx = jnp.arange(L)
    all_valid = window_all(valid, k)
    in_range = idx + k <= L

    # last-window-of-record rule: emitted only if previous base valid
    is_final_window = jnp.concatenate(
        [rec_last[k - 1 :], jnp.zeros(min(k - 1, L), dtype=bool)]
    )
    prev_valid = jnp.concatenate([jnp.zeros(1, bool), valid[:-1]])
    emit = all_valid & in_range & (~is_final_window | prev_valid)

    ph = pack_n(codes_limbs, h)
    upper = K.shl(ph, 2 * h)
    lower = _shift_left_arr(ph, h + 1)
    key = upper | lower
    mid = _shift_left_arr(codes, h).astype(jnp.uint8)

    if rc:
        rkey = K.rev_comp(key, k - 1)
        swap = K.greater(key, rkey)
        pal = K.equal(key, rkey)
        ckey = jnp.where(swap[:, None], rkey, key)
        cmid = jnp.where(swap, mid ^ 2, mid)
    else:
        ckey, cmid = key, mid
        swap = jnp.zeros(L, bool)
        pal = jnp.zeros(L, bool)

    out = {"key": ckey, "mid": cmid, "is_rc": swap, "pal": pal, "emit": emit}

    if want_whole:
        mid_limbs = jnp.zeros((L, W), dtype=U64).at[:, W - 1].set(
            _shift_left_arr(codes, h)
        )
        whole = K.shl(ph, 2 * (h + 1)) | K.shl(mid_limbs, 2 * h) | lower
        if rc:
            rwhole = K.rev_comp(whole, k)
            whole = jnp.where(K.greater(whole, rwhole)[:, None], rwhole, whole)
        out["whole"] = whole
    return out
