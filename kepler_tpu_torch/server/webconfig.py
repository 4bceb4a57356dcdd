"""Web config file: TLS + basic auth for the API server.

Reference parity: ``internal/server/server.go:136-156`` hands the listener
to ``prometheus/exporter-toolkit`` when ``web.config-file`` is set. This
module reads the same file format (the exporter-toolkit subset that the
reference's ``server_tls_test.go`` exercises):

.. code-block:: yaml

    tls_server_config:
      cert_file: /path/server.crt
      key_file: /path/server.key
    basic_auth_users:
      alice: $2y$10$...       # bcrypt (needs the optional bcrypt module)
      bob: $5$rounds=...      # or crypt(3) sha256/sha512 from stdlib

Password hashes: exporter-toolkit mandates bcrypt; that module is optional
here, so SHA-crypt ``$5$``/``$6$`` hashes are accepted as the
always-available alternative, verified by the pure-Python
:mod:`kepler_tpu_torch.server.shacrypt` (the stdlib ``crypt`` module this path
once used was removed in Python 3.13). Generate one with
``python -c "from kepler_tpu_torch.server.shacrypt import mksha512crypt;
print(mksha512crypt('pw'))"``.
"""

from __future__ import annotations

import base64
import binascii
import logging
from dataclasses import dataclass, field
from typing import Callable, Mapping

log = logging.getLogger("kepler.server")


@dataclass
class WebConfigFile:
    cert_file: str = ""
    key_file: str = ""
    basic_auth_users: dict[str, str] = field(default_factory=dict)

    @property
    def has_tls(self) -> bool:
        return bool(self.cert_file and self.key_file)


def load_web_config(path: str) -> WebConfigFile:
    """Parse + validate a web config file (exporter-toolkit subset)."""
    import yaml  # only a web config file needs it

    with open(path, encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, Mapping):
        raise ValueError(f"web config {path!r}: root must be a mapping")
    known = {"tls_server_config", "basic_auth_users"}
    unknown = set(data) - known
    if unknown:
        raise ValueError(f"web config {path!r}: unknown keys {sorted(unknown)}"
                         f" (supported: {sorted(known)})")
    tls = data.get("tls_server_config") or {}
    if not isinstance(tls, Mapping):
        raise ValueError("tls_server_config must be a mapping")
    cert = str(tls.get("cert_file", "") or "")
    key = str(tls.get("key_file", "") or "")
    if bool(cert) != bool(key):
        raise ValueError("tls_server_config needs both cert_file and key_file")
    users = data.get("basic_auth_users") or {}
    if not isinstance(users, Mapping):
        raise ValueError("basic_auth_users must be a mapping")
    users = {str(u): str(h) for u, h in users.items()}
    for user, h in users.items():
        _verify_hash_supported(user, h)
    return WebConfigFile(cert_file=cert, key_file=key,
                         basic_auth_users=users)


def _verify_hash_supported(user: str, h: str) -> None:
    if h.startswith(("$2a$", "$2b$", "$2y$")):
        try:
            import bcrypt  # noqa: F401
        except ImportError:
            raise ValueError(
                f"basic_auth_users[{user!r}]: bcrypt hash but the bcrypt "
                "module is not installed; use a crypt(3) $5$/$6$ hash "
                "instead") from None
        return
    if h.startswith(("$5$", "$6$")):
        return  # SHA-crypt: verified by the bundled pure-Python shacrypt
    raise ValueError(
        f"basic_auth_users[{user!r}]: unsupported hash format "
        f"{h[:4]!r}… (supported: bcrypt $2*$, SHA-crypt $5$/$6$)")


def _check_password(password: str, hashed: str) -> bool:
    if hashed.startswith(("$2a$", "$2b$", "$2y$")):
        import bcrypt

        return bcrypt.checkpw(password.encode(), hashed.encode())
    from kepler_tpu_torch.server import shacrypt

    return shacrypt.verify(password, hashed)


def _make_dummy_hash(users: Mapping[str, str]) -> str:
    """A fixed dummy hash for unknown-user verifies, PRECOMPUTED once at
    authenticator build time from an unguessable password.

    The previous equalizer verified against ``next(iter(users.values()))``
    — an arbitrary REAL user's hash. With mixed bcrypt/SHA-crypt configs
    that pins the unknown-user cost to whichever scheme happens to sit
    first in dict order, so the timing difference against a probe of a
    known user under the OTHER scheme leaked username existence (and it
    ran a real credential check against a real hash with attacker-chosen
    input). The dummy is its own hash: bcrypt when any configured user is
    bcrypt (the costlier scheme), SHA-512-crypt otherwise — at the MAX
    cost parameter configured for that scheme, so within a scheme an
    unknown-user verify is never cheaper than a real one (a lower-cost
    dummy would leak existence by being faster than the costliest user).
    Users configured with differing costs remain distinguishable from
    each other by timing regardless of what the dummy does — per-user
    cost divergence is a config smell, not something a dummy can mask.
    """
    import re
    import secrets

    password = secrets.token_hex(16)
    bcrypt_hashes = [h for h in users.values()
                     if h.startswith(("$2a$", "$2b$", "$2y$"))]
    if bcrypt_hashes:
        import bcrypt  # load_web_config verified availability

        costs = [int(m.group(1)) for h in bcrypt_hashes
                 if (m := re.match(r"\$2[aby]\$(\d{2})\$", h))]
        salt = bcrypt.gensalt(rounds=max(costs)) if costs \
            else bcrypt.gensalt()
        return bcrypt.hashpw(password.encode(), salt).decode()
    from kepler_tpu_torch.server import shacrypt

    # a rounds-less $5/$6 hash runs at the scheme default — it must
    # count toward the max or default-cost users would out-cost the dummy
    rounds = [int(m.group(1))
              if (m := re.match(r"\$[56]\$rounds=(\d+)\$", h))
              else shacrypt._ROUNDS_DEFAULT
              for h in users.values()]
    return shacrypt.mksha512crypt(password,
                                  rounds=max(rounds) if rounds else None)


def make_authenticator(users: Mapping[str, str]
                       ) -> Callable[[str | None], bool] | None:
    """→ fn(Authorization header) -> allowed, or None when auth is off."""
    if not users:
        return None
    # unknown-user timing equalizer: a fixed constant-cost dummy hash,
    # never a configured user's real hash (see _make_dummy_hash)
    dummy_hash = _make_dummy_hash(users)

    def check(header: str | None) -> bool:
        if not header or not header.startswith("Basic "):
            return False
        try:
            raw = base64.b64decode(header[6:], validate=True).decode()
            user, _, password = raw.partition(":")
        except (binascii.Error, UnicodeDecodeError):
            return False
        hashed = users.get(user)
        try:
            if hashed is None:
                # burn the dummy verify so a timing probe can't
                # enumerate usernames; the result is discarded
                _check_password(password, dummy_hash)
                return False
            return _check_password(password, hashed)
        except Exception:
            log.exception("basic-auth check failed for user %r", user)
            return False

    return check


def make_api_server(listen_addresses: list[str], config_file: str = "",
                    max_connections: int = 0):
    """API server honouring a web config file (TLS + basic auth) —
    reference ``server.go:136-156`` via exporter-toolkit. Shared by the
    node-agent and aggregator entry points. ``max_connections`` caps
    concurrent handler threads (``web.maxConnections``; 0 = unbounded)."""
    from kepler_tpu_torch.server.http import APIServer

    web = load_web_config(config_file) if config_file else None
    return APIServer(
        listen_addresses=listen_addresses,
        tls_cert=web.cert_file if web else "",
        tls_key=web.key_file if web else "",
        basic_auth_check=(make_authenticator(web.basic_auth_users)
                          if web else None),
        max_connections=max_connections,
    )
