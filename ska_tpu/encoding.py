"""2-bit DNA encoding, IUPAC base-set algebra and packed-key bit ops.

Replaces the reference's lookup-table layer (src/ska_dict/bit_encoding.rs)
with a set-based formulation that vectorizes on the device:

- bases encode as 2 bits: A:00 C:01 T:10 G:11 via ``(ascii >> 1) & 3``
  (bit_encoding.rs:34-36); reverse complement is ``b ^ 2`` (:46-48).
- the middle-base ambiguity algebra (the 1024-entry IUPAC table,
  bit_encoding.rs:388-453) is exactly set union over the 4-element base
  set, so we carry middle bases internally as 4-bit sets
  (bit A=1, C=2, T=4, G=8, i.e. ``1 << code``) and reduce with bitwise OR.
  ASCII IUPAC codes exist only at I/O boundaries.
- the self-palindrome W/S/N rule (src/ska_dict.rs:85-113) is the same
  union where an occurrence contributes ``{b, rc(b)}`` instead of ``{b}``.

All tables are numpy arrays usable in both host code and jnp gathers.
"""

import numpy as np

# --- scalar/ASCII level ------------------------------------------------------

LETTER_CODE = np.frombuffer(b"ACTG", dtype=np.uint8)  # 2-bit code -> ASCII


def encode_base(ascii_u8):
    """ASCII base -> 2-bit code (works upper/lowercase). bit_encoding.rs:34-36."""
    return (ascii_u8 >> 1) & 0x3


def rc_base(code):
    """Reverse complement of a 2-bit code. bit_encoding.rs:46-48."""
    return code ^ 2


def valid_base(ascii_u8):
    """True unless N or n. Other IUPAC letters in *input* are silently
    2-bit-projected, same as the reference (bit_encoding.rs:52-54)."""
    return (ascii_u8 & 0xF) != 14


# --- 4-bit base sets ---------------------------------------------------------

# set bit for a 2-bit code
CODE_TO_SET = np.array([1, 2, 4, 8], dtype=np.uint8)

# 16-entry set -> ASCII IUPAC (0 = missing '-')
_SET_ASCII = {
    0: ord("-"),
    1: ord("A"), 2: ord("C"), 4: ord("T"), 8: ord("G"),
    3: ord("M"), 5: ord("W"), 9: ord("R"),
    6: ord("Y"), 10: ord("S"), 12: ord("K"),
    7: ord("H"), 11: ord("V"), 13: ord("D"), 14: ord("B"),
    15: ord("N"),
}
SET_TO_ASCII = np.array([_SET_ASCII[i] for i in range(16)], dtype=np.uint8)

# ASCII -> 4-bit set (unknown chars -> 0)
ASCII_TO_SET = np.zeros(256, dtype=np.uint8)
for _s, _a in _SET_ASCII.items():
    if _s:
        ASCII_TO_SET[_a] = _s
        ASCII_TO_SET[_a | 0x20] = _s  # lowercase
ASCII_TO_SET[ord("U")] = 4  # U behaves as T
ASCII_TO_SET[ord("u")] = 4

# reverse complement of a 4-bit set: swap A<->T and C<->G bits
_RC_SET = np.zeros(16, dtype=np.uint8)
for _s in range(16):
    r = 0
    if _s & 1:
        r |= 4  # A -> T
    if _s & 4:
        r |= 1  # T -> A
    if _s & 2:
        r |= 8  # C -> G
    if _s & 8:
        r |= 2  # G -> C
    _RC_SET[_s] = r
RC_SET = _RC_SET

# ASCII IUPAC -> reverse complement ASCII, with '-' for anything unknown
# (reference RC_IUPAC, bit_encoding.rs:475-508)
RC_IUPAC = np.full(256, ord("-"), dtype=np.uint8)
for _a in range(256):
    _s = ASCII_TO_SET[_a]
    if _s:
        RC_IUPAC[_a] = SET_TO_ASCII[RC_SET[_s]]
# The reference maps 'U'/'u' to 'A' via its table; set algebra gives 'A' too
# because U's set is T's set. 'N' -> 'N', '-' -> '-' (default fill).

# True for anything not a/c/g/t/u/- (reference is_ambiguous, :58-61)
IS_AMBIGUOUS = np.ones(256, dtype=bool)
for _c in b"acgtuACGTU-":
    IS_AMBIGUOUS[_c] = False

# ASCII -> probability 4-vector [p(A), p(C), p(T), p(G)]
# (reference base_to_prob, bit_encoding.rs:65-85; note N -> zeros)
BASE_PROB = np.zeros((256, 4), dtype=np.float64)
for _a in range(256):
    _s = int(ASCII_TO_SET[_a])
    if _s == 0 or _s == 15:  # '-' and N give zero vectors
        continue
    bits = [i for i in range(4) if _s & (1 << i)]  # i is bit for A,C,T,G
    for i in bits:
        BASE_PROB[_a, i] = 1.0 / len(bits)


# --- packed-key bit operations (host/numpy; jnp versions in ops) -------------


def rev_comp_u64(x, n_bases):
    """Reverse complement of 2-bit-packed bases in a uint64.

    Matches reference UInt::rev_comp for u64 (bit_encoding.rs:182-195),
    with k_size = n_bases. Vectorized over numpy arrays.
    """
    x = np.asarray(x, dtype=np.uint64).copy()
    m = np.uint64
    x = ((x >> m(2)) & m(0x3333333333333333)) | ((x & m(0x3333333333333333)) << m(2))
    x = ((x >> m(4)) & m(0x0F0F0F0F0F0F0F0F)) | ((x & m(0x0F0F0F0F0F0F0F0F)) << m(4))
    x = ((x >> m(8)) & m(0x00FF00FF00FF00FF)) | ((x & m(0x00FF00FF00FF00FF)) << m(8))
    x = ((x >> m(16)) & m(0x0000FFFF0000FFFF)) | ((x & m(0x0000FFFF0000FFFF)) << m(16))
    x = (x >> m(32)) | (x << m(32))
    x ^= m(0xAAAAAAAAAAAAAAAA)
    return x >> m(2 * (32 - n_bases))


def decode_packed(x_hi, x_lo, n_bases):
    """Decode a 2-bit packed value (two uint64 limbs, hi:lo) to an ASCII string."""
    out = bytearray()
    for i in range(n_bases - 1, -1, -1):
        bitpos = 2 * i
        if bitpos >= 64:
            code = (int(x_hi) >> (bitpos - 64)) & 3
        else:
            code = (int(x_lo) >> bitpos) & 3
        out.append(LETTER_CODE[code])
    return out.decode()
