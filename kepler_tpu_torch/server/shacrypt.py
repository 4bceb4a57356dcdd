"""Pure-Python SHA-crypt ($5$ sha256 / $6$ sha512) password verification.

Replaces the stdlib ``crypt`` module in the basic-auth path
(``webconfig.py``): ``crypt(3)`` was deprecated in Python 3.11 and
REMOVED in 3.13, so hash verification must not depend on it. This is an
independent implementation of Ulrich Drepper's public SHA-crypt
specification (https://www.akkadia.org/drepper/SHA-crypt.txt, released
to the public domain) — the same scheme glibc's ``crypt(3)`` implements
— and is fuzz-verified against the real ``crypt(3)`` in
``tests/test_server_tls.py`` wherever that module still exists.

Reference parity: the reference delegates basic auth to
``prometheus/exporter-toolkit`` (``internal/server/server.go:136-156``),
which mandates bcrypt; this repo additionally accepts SHA-crypt hashes
so auth works without the optional ``bcrypt`` dependency.

Only verification (and the hash computation it needs) is provided —
generating new hashes should use ``mksha512crypt`` below or any htpasswd
tooling.
"""

from __future__ import annotations

import hashlib
import hmac
import re
import secrets

_B64_CHARS = "./0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

# Output-byte permutations from the spec (step 22): digest bytes are
# regrouped into 24-bit words before base64 coding.
_ORDER_512 = (
    (0, 21, 42), (22, 43, 1), (44, 2, 23), (3, 24, 45), (25, 46, 4),
    (47, 5, 26), (6, 27, 48), (28, 49, 7), (50, 8, 29), (9, 30, 51),
    (31, 52, 10), (53, 11, 32), (12, 33, 54), (34, 55, 13), (56, 14, 35),
    (15, 36, 57), (37, 58, 16), (59, 17, 38), (18, 39, 60), (40, 61, 19),
    (62, 20, 41),
)
_ORDER_256 = (
    (0, 10, 20), (21, 1, 11), (12, 22, 2), (3, 13, 23), (24, 4, 14),
    (15, 25, 5), (6, 16, 26), (27, 7, 17), (18, 28, 8), (9, 19, 29),
)

_ROUNDS_DEFAULT = 5000
_ROUNDS_MIN = 1000
_ROUNDS_MAX = 999_999_999
_SALT_MAX = 16

_HASH_RE = re.compile(
    r"^\$(?P<id>5|6)\$(?:rounds=(?P<rounds>\d+)\$)?"
    r"(?P<salt>[^$]{0,16})\$(?P<digest>[./0-9A-Za-z]+)$")


def _b64_from_24bit(b2: int, b1: int, b0: int, n: int) -> str:
    w = (b2 << 16) | (b1 << 8) | b0
    out = []
    for _ in range(n):
        out.append(_B64_CHARS[w & 0x3F])
        w >>= 6
    return "".join(out)


def _encode_digest(digest: bytes, use_512: bool) -> str:
    order = _ORDER_512 if use_512 else _ORDER_256
    parts = [_b64_from_24bit(digest[a], digest[b], digest[c], 4)
             for a, b, c in order]
    if use_512:
        parts.append(_b64_from_24bit(0, 0, digest[63], 2))
    else:
        parts.append(_b64_from_24bit(0, digest[31], digest[30], 3))
    return "".join(parts)


def _sha_crypt_digest(password: bytes, salt: bytes, rounds: int,
                      use_512: bool) -> bytes:
    """Steps 1-21 of the spec, shared by the $5$ and $6$ variants."""
    H = hashlib.sha512 if use_512 else hashlib.sha256
    dlen = 64 if use_512 else 32

    # B: password + salt + password (steps 4-8)
    b = H(password + salt + password).digest()
    # A: password + salt + B stretched to len(password) + binary-length
    # walk over B/password (steps 1-3, 9-12)
    a = H()
    a.update(password)
    a.update(salt)
    n = len(password)
    a.update(b * (n // dlen) + b[: n % dlen])
    bits = n
    while bits > 0:
        a.update(b if bits & 1 else password)
        bits >>= 1
    a_digest = a.digest()

    # DP → P: password repeated len(password) times (steps 13-16)
    dp = H(password * n).digest()
    p = dp * (n // dlen) + dp[: n % dlen]
    # DS → S: salt repeated 16 + A[0] times (steps 17-20)
    ds = H(salt * (16 + a_digest[0])).digest()
    s = ds * (len(salt) // dlen) + ds[: len(salt) % dlen]

    # step 21: the rounds loop
    c = a_digest
    for i in range(rounds):
        h = H()
        h.update(p if i % 2 else c)
        if i % 3:
            h.update(s)
        if i % 7:
            h.update(p)
        h.update(c if i % 2 else p)
        c = h.digest()
    return c


def sha_crypt(password: str | bytes, salt_spec: str) -> str:
    """Full crypt(3)-compatible hash for ``salt_spec`` = ``$5$…``/``$6$…``.

    ``salt_spec`` may be a bare salt spec (``$6$somesalt``, with optional
    ``rounds=N$``) or a complete prior hash — matching ``crypt.crypt``'s
    contract that ``crypt(pw, hashed) == hashed`` verifies a password.
    """
    m = re.match(
        r"^\$(?P<id>5|6)\$(?:rounds=(?P<rounds>\d+)\$)?(?P<salt>[^$]{0,16})",
        salt_spec)
    if m is None:
        raise ValueError(f"unsupported salt spec {salt_spec[:8]!r}…")
    use_512 = m.group("id") == "6"
    rounds_given = m.group("rounds") is not None
    rounds = int(m.group("rounds")) if rounds_given else _ROUNDS_DEFAULT
    rounds = max(_ROUNDS_MIN, min(_ROUNDS_MAX, rounds))
    salt = m.group("salt")[:_SALT_MAX]
    pw = password.encode() if isinstance(password, str) else password
    digest = _sha_crypt_digest(pw, salt.encode(), rounds, use_512)
    prefix = f"${m.group('id')}$"
    if rounds_given:
        prefix += f"rounds={rounds}$"
    return f"{prefix}{salt}${_encode_digest(digest, use_512)}"


def verify(password: str | bytes, hashed: str) -> bool:
    """Constant-time check of ``password`` against a $5$/$6$ hash."""
    if _HASH_RE.match(hashed) is None:
        return False
    return hmac.compare_digest(sha_crypt(password, hashed), hashed)


def mksha512crypt(password: str, rounds: int | None = None) -> str:
    """Generate a fresh ``$6$`` hash (utility for htpasswd-style setup)."""
    salt = "".join(secrets.choice(_B64_CHARS) for _ in range(_SALT_MAX))
    spec = (f"$6$rounds={rounds}${salt}" if rounds is not None
            else f"$6${salt}")
    return sha_crypt(password, spec)
