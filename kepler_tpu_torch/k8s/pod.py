"""Pod metadata informer.

Reference parity: ``internal/k8s/pod/pod.go`` — a cached, node-filtered view
of the K8s API: pods are watched with a ``spec.nodeName=<this node>`` field
selector (:139-144), indexed by every containerID including init and
ephemeral containers (:155-196, container IDs stripped of their
``scheme://`` prefix :198), giving O(1)
``lookup_by_container_id → (pod_id, pod_name, namespace, container_name)``.

Implementation: a dependency-free Kubernetes REST client (stdlib urllib +
ssl) — the runtime image carries no ``kubernetes`` package. LIST seeds the
cache; WATCH (chunked JSON stream with resourceVersion resume) keeps it warm;
a periodic full re-list guards against missed events. Credentials come from
an explicit kubeconfig path or the in-cluster service-account token.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import ssl
import tempfile
import threading
import urllib.error
import urllib.request
from typing import Mapping

import yaml

from kepler_tpu_torch.service.lifecycle import CancelContext

log = logging.getLogger("kepler.k8s.pod")

_IN_CLUSTER_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"
_IN_CLUSTER_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


def _strip_scheme(container_id: str) -> str:
    """``containerd://abc…`` → ``abc…`` (reference extractContainerID :198)."""
    _, sep, rest = container_id.partition("://")
    return rest if sep else container_id


class KubeClient:
    """Minimal authenticated GET against the API server."""

    def __init__(self, kubeconfig: str = "") -> None:
        self.base_url = ""
        self._token = ""
        self._ssl_ctx: ssl.SSLContext | None = None
        if kubeconfig:
            self._from_kubeconfig(kubeconfig)
        else:
            self._from_in_cluster()

    def _from_kubeconfig(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f)
        ctx_name = cfg.get("current-context", "")
        contexts = {c["name"]: c["context"] for c in cfg.get("contexts", [])}
        clusters = {c["name"]: c["cluster"] for c in cfg.get("clusters", [])}
        users = {u["name"]: u["user"] for u in cfg.get("users", [])}
        ctx = contexts.get(ctx_name) or next(iter(contexts.values()), None)
        if ctx is None:
            raise ValueError(f"kubeconfig {path} has no usable context")
        cluster = clusters[ctx["cluster"]]
        user = users.get(ctx.get("user", ""), {})
        self.base_url = cluster["server"].rstrip("/")
        self._ssl_ctx = self._build_ssl(cluster, user)
        if "token" in user:
            self._token = user["token"]

    def _build_ssl(self, cluster: Mapping, user: Mapping) -> ssl.SSLContext:
        ctx = ssl.create_default_context()
        if cluster.get("insecure-skip-tls-verify"):
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        ca_data = cluster.get("certificate-authority-data")
        ca_file = cluster.get("certificate-authority")
        if ca_data:
            ctx.load_verify_locations(
                cadata=base64.b64decode(ca_data).decode())
        elif ca_file:
            ctx.load_verify_locations(cafile=ca_file)
        cert_data = user.get("client-certificate-data")
        key_data = user.get("client-key-data")
        if cert_data and key_data:
            # stdlib ssl needs files for client certs
            cert_f = tempfile.NamedTemporaryFile(
                mode="wb", suffix=".pem", delete=False)
            cert_f.write(base64.b64decode(cert_data))
            cert_f.write(b"\n")
            cert_f.write(base64.b64decode(key_data))
            cert_f.close()
            ctx.load_cert_chain(cert_f.name)
        elif user.get("client-certificate") and user.get("client-key"):
            ctx.load_cert_chain(user["client-certificate"],
                                user["client-key"])
        return ctx

    def _from_in_cluster(self) -> None:
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host or not os.path.exists(_IN_CLUSTER_TOKEN):
            raise RuntimeError(
                "not running in a cluster and no kubeconfig provided")
        self.base_url = f"https://{host}:{port}"
        with open(_IN_CLUSTER_TOKEN, encoding="ascii") as f:
            self._token = f.read().strip()
        ctx = ssl.create_default_context()
        if os.path.exists(_IN_CLUSTER_CA):
            ctx.load_verify_locations(cafile=_IN_CLUSTER_CA)
        self._ssl_ctx = ctx

    def get(self, path: str, timeout: float = 30.0):
        """GET returning a file-like response (caller reads/streams)."""
        req = urllib.request.Request(self.base_url + path)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        return urllib.request.urlopen(
            req, timeout=timeout, context=self._ssl_ctx)


class PodInformer:
    """Node-filtered pod cache with containerID index."""

    def __init__(
        self,
        node_name: str,
        kubeconfig: str = "",
        resync_interval: float = 300.0,
        client: KubeClient | None = None,
        backoff_base: float = 1.0,
        backoff_cap: float = 30.0,
        rng=None,
    ) -> None:
        import random

        self._node_name = node_name
        self._kubeconfig = kubeconfig
        self._resync = resync_interval
        self._client = client
        # jittered exponential backoff for consecutive watch failures
        # (controller-runtime reflector analog; jitter keeps a fleet of
        # node agents from hitting a flapping API server in lockstep)
        self._backoff_base = backoff_base
        self._backoff_cap = (min(backoff_cap, resync_interval)
                             if resync_interval > 0 else backoff_cap)
        self._rng = rng or random.Random()
        self._made_progress = False
        self._lock = threading.Lock()
        # containerID → (pod_id, pod_name, namespace, container_name)
        self._index: dict[str, tuple[str, str, str, str]] = {}
        # pod uid → set of containerIDs (for delete handling)
        self._pod_containers: dict[str, set[str]] = {}
        self._resource_version = ""

    def name(self) -> str:
        return "pod-informer"

    # -- lifecycle ---------------------------------------------------------

    def init(self) -> None:
        if self._client is None:
            self._client = KubeClient(self._kubeconfig)
        self.relist()
        log.info("pod informer primed: %d containers on node %s",
                 len(self._index), self._node_name)

    def run(self, ctx: CancelContext) -> None:
        """Watch + periodic re-list (controller-runtime cache analog).

        A watch ``ERROR`` event (e.g. 410 Gone after an API-server restart
        compacts our resourceVersion) triggers an *immediate* re-list rather
        than waiting out the stream timeout — the recovery controller-runtime
        performs for the reference (``internal/k8s/pod/pod.go:136-196``).
        Only the FIRST consecutive failure gets the fast path; repeated
        failures (the server rejecting watch after watch, or the re-list
        itself failing) wait out a *jittered exponential backoff*
        (base·2^k capped, ×[0.5, 1.5) jitter) so a flapping API server is
        not hit in lockstep by every node agent — the reflector's backoff
        analog. Any successfully-applied watch event resets the streak.
        """
        failures = 0
        while not ctx.cancelled():
            expired = False
            failed = False
            self._made_progress = False
            try:
                expired = self._watch(ctx)
            except Exception as err:
                failed = True
                log.warning("pod watch interrupted: %s", err)
            if ctx.cancelled():
                return
            if self._made_progress:
                failures = 0  # the stream was healthy before it ended
            if expired and failures == 0:
                try:
                    self.relist()
                    failures = 1  # a second rejection backs off
                    continue  # fresh resourceVersion: re-watch right away
                except Exception as err:
                    failed = True
                    log.warning("pod re-list after ERROR failed: %s", err)
            if expired or failed:
                failures += 1
                delay = self._watch_backoff(failures)
                log.warning("pod watch failing (streak=%d); backing off "
                            "%.2fs", failures, delay)
            else:
                # clean close (even with zero events on a quiet node) is
                # healthy: isolated errors hours apart must not accumulate
                # into a "consecutive" streak
                failures = 0
                delay = min(5.0, self._resync)
            if ctx.wait(delay):
                return
            try:
                self.relist()
            except Exception as err:
                failures += 1
                log.warning("pod re-list failed: %s", err)

    def _watch_backoff(self, failures: int) -> float:
        """Jittered exponential delay for the k-th consecutive failure.
        The exponent is clamped — a multi-hour outage must saturate at the
        cap, not overflow float exponentiation (2.0**1024 raises)."""
        base = min(self._backoff_base * (2.0 ** min(failures - 1, 30)),
                   self._backoff_cap)
        return base * (0.5 + self._rng.random())

    # -- cache maintenance -------------------------------------------------

    def _pods_path(self, watch: bool = False) -> str:
        sel = f"spec.nodeName%3D{self._node_name}"
        path = f"/api/v1/pods?fieldSelector={sel}"
        if watch:
            path += (f"&watch=true&resourceVersion={self._resource_version}"
                     "&allowWatchBookmarks=true")
        return path

    def relist(self) -> None:
        assert self._client is not None
        with self._client.get(self._pods_path()) as resp:
            data = json.load(resp)
        with self._lock:
            self._index.clear()
            self._pod_containers.clear()
            for pod in data.get("items", []):
                self._upsert_locked(pod)
            self._resource_version = data.get("metadata", {}).get(
                "resourceVersion", "")

    def _watch(self, ctx: CancelContext) -> bool:
        """Consume one watch stream. Returns True when the stream must be
        abandoned because the server declared our resourceVersion stale
        (ERROR event, typically 410 Gone)."""
        assert self._client is not None
        with self._client.get(self._pods_path(watch=True),
                              timeout=60.0) as resp:
            buf = b""
            while not ctx.cancelled():
                chunk = resp.readline()
                if not chunk:
                    return False  # stream closed; caller re-lists
                buf += chunk
                if not buf.endswith(b"\n"):
                    continue
                try:
                    event = json.loads(buf)
                except json.JSONDecodeError:
                    continue  # partial frame
                finally:
                    buf = b""
                if self._apply_event(event):
                    return True
        return False

    def _apply_event(self, event: Mapping) -> bool:
        """Fold one watch event into the cache. Returns True when the watch
        is expired and the caller must re-list (reference relies on
        controller-runtime's reflector for this, ``pod.go:136-144``)."""
        kind = event.get("type")
        pod = event.get("object", {})
        if kind == "ERROR":
            # object is a v1.Status; 410 Gone means our resourceVersion was
            # compacted away. Drop it so the next LIST starts fresh.
            log.warning(
                "pod watch ERROR (code=%s reason=%s): re-listing",
                pod.get("code"), pod.get("reason"))
            with self._lock:
                self._resource_version = ""
            return True
        rv = pod.get("metadata", {}).get("resourceVersion")
        if kind in ("ADDED", "MODIFIED", "DELETED"):
            # only real object events count as progress — a BOOKMARK
            # applies nothing, and a server that serves bookmark-then-410
            # every cycle must still escalate the backoff, not reset it
            self._made_progress = True
        with self._lock:
            if rv:
                self._resource_version = rv
            if kind == "BOOKMARK":
                pass  # resourceVersion checkpoint only; no cache change
            elif kind in ("ADDED", "MODIFIED"):
                self._remove_locked(pod)
                self._upsert_locked(pod)
            elif kind == "DELETED":
                self._remove_locked(pod)
        return False

    def _upsert_locked(self, pod: Mapping) -> None:
        meta = pod.get("metadata", {})
        uid = meta.get("uid", "")
        pod_name = meta.get("name", "")
        namespace = meta.get("namespace", "")
        status = pod.get("status", {})
        ids: set[str] = set()
        # regular + init + ephemeral containers (reference indexerFunc
        # :167-196)
        for key in ("containerStatuses", "initContainerStatuses",
                    "ephemeralContainerStatuses"):
            for cs in status.get(key, []) or []:
                cid = _strip_scheme(cs.get("containerID", "") or "")
                if not cid:
                    continue
                ids.add(cid)
                self._index[cid] = (uid, pod_name, namespace,
                                    cs.get("name", ""))
        if ids:
            self._pod_containers[uid] = ids

    def _remove_locked(self, pod: Mapping) -> None:
        uid = pod.get("metadata", {}).get("uid", "")
        for cid in self._pod_containers.pop(uid, ()):
            self._index.pop(cid, None)

    # -- query API ---------------------------------------------------------

    def lookup_by_container_id(
        self, container_id: str
    ) -> tuple[str, str, str, str] | None:
        """O(1) containerID → pod metadata (reference LookupByContainerID
        :209-239)."""
        with self._lock:
            return self._index.get(_strip_scheme(container_id))
