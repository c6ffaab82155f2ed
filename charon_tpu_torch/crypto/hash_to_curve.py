"""Hash-to-curve for BLS12-381 G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_): the
host half and the constants of the device map.

The port's own copy of the parts of charon_tpu/crypto/hash_to_curve.py that
the device hash-to-G2 (ops/h2c.py) needs: `expand_message_xmd` and
`hash_to_field_fq2` (SHA-256 and bytes stay on the host), the SSWU
constants of the 3-isogenous curve E', sgn0, the 3-isogeny coefficients
(RFC 9380 Appendix E.3) and the ETH ciphersuite DST. The map itself (SSWU,
the 3-isogeny and cofactor clearing) runs on the device.
"""

from __future__ import annotations

import hashlib

from . import fields as F

# --- expand_message_xmd (SHA-256) -------------------------------------------


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    b_in_bytes = 32
    r_in_bytes = 64
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255:
        raise ValueError("expand_message_xmd: len too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(r_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    prev = b1
    for i in range(2, ell + 1):
        prev = hashlib.sha256(bytes(x ^ y for x, y in zip(b0, prev)) + bytes([i]) + dst_prime).digest()
        out.append(prev)
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fq2(msg: bytes, dst: bytes, count: int) -> list:
    """count elements of Fq2, L=64 per base-field coordinate."""
    L = 64
    m = 2
    uniform = expand_message_xmd(msg, dst, count * m * L)
    out = []
    for i in range(count):
        coords = []
        for j in range(m):
            off = L * (j + i * m)
            coords.append(int.from_bytes(uniform[off : off + L], "big") % F.P)
        out.append(tuple(coords))
    return out


# --- simplified SWU on the isogenous curve E' --------------------------------
# E': y^2 = x^3 + A' x + B' over Fq2 with
A_ISO = (0, 240)
B_ISO = (1012, 1012)
Z_SSWU = (F.P - 2, F.P - 1)  # Z = -(2 + u)
_NEG_B_OVER_A = F.fq2_mul(F.fq2_neg(B_ISO), F.fq2_inv(A_ISO))


def _sgn0_fq2(x) -> int:
    sign = 0
    zero = 1
    for c in x:
        sign_i = c & 1
        zero_i = 1 if c == 0 else 0
        sign = sign | (zero & sign_i)
        zero = zero & zero_i
    return sign



# --- 3-isogeny map E' -> E ---------------------------------------------------
# Coefficients from RFC 9380 Appendix E.3.

_K1 = [  # x numerator, degree 3
    (
        0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    (
        0,
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    (
        0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
        0,
    ),
]
_K2 = [  # x denominator, degree 2 + monic x^2
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63,
    ),
    (
        0xC,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F,
    ),
]
_K3 = [  # y numerator, degree 3
    (
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    (
        0,
        0x05C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE,
    ),
    (
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x08AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    (
        0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
        0,
    ),
]
_K4 = [  # y denominator, degree 3 + monic x^3
    (
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    (
        0,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3,
    ),
    (
        0x12,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99,
    ),
]



# ETH2 BLS signature ciphersuite DST (proof-of-possession scheme).
DST_ETH = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
