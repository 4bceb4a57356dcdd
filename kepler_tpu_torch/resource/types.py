"""Workload types.

Reference parity: ``internal/resource/types.go`` — Process / Container /
VirtualMachine / Pod with cumulative CPU time + per-interval delta, runtime
and hypervisor enums.

Design: these objects are the *metadata* view; the attribution math
never iterates them. ``informer.FeatureBatch`` carries the numeric columns
(cpu_time_delta per workload) as numpy arrays aligned to stable row indices.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace


class ContainerRuntime(str, enum.Enum):
    UNKNOWN = "unknown"
    DOCKER = "docker"
    CONTAINERD = "containerd"
    CRIO = "crio"
    PODMAN = "podman"
    KUBEPODS = "kubepods"


class Hypervisor(str, enum.Enum):
    UNKNOWN = "unknown"
    KVM = "kvm"


@dataclass
class Pod:
    id: str
    name: str = ""
    namespace: str = ""
    cpu_total_time: float = 0.0
    cpu_time_delta: float = 0.0
    # exporter label dict, built lazily and treated as immutable; set to
    # None whenever an identity field changes so label caches re-render
    meta_cache: dict | None = None

    def clone(self) -> "Pod":
        return replace(self)


@dataclass
class Container:
    id: str
    name: str = ""
    runtime: ContainerRuntime = ContainerRuntime.UNKNOWN
    pod_id: str | None = None
    cpu_total_time: float = 0.0
    cpu_time_delta: float = 0.0
    meta_cache: dict | None = None

    def clone(self) -> "Container":
        return replace(self)


@dataclass
class VirtualMachine:
    id: str
    name: str = ""
    hypervisor: Hypervisor = Hypervisor.UNKNOWN
    cpu_total_time: float = 0.0
    cpu_time_delta: float = 0.0
    meta_cache: dict | None = None

    def clone(self) -> "VirtualMachine":
        return replace(self)


@dataclass
class Process:
    pid: int
    comm: str = ""
    exe: str = ""
    cmdline: list[str] = field(default_factory=list)
    cpu_total_time: float = 0.0
    cpu_time_delta: float = 0.0
    container: Container | None = None
    virtual_machine: VirtualMachine | None = None
    # classification already ran (container/VM/regular verdict is cached;
    # reference caches via Process.Type in populateProcessFields)
    classified: bool = False
    # raw comm bytes from the batched stat scan (cheap change detection
    # without decoding 10k strings per tick)
    comm_raw: bytes = b""
    meta_cache: dict | None = None

    def clone(self) -> "Process":
        c = replace(self, cmdline=list(self.cmdline))
        return c


@dataclass
class Node:
    """Node-level CPU accounting (reference types.go Node / informer node)."""

    cpu_usage_ratio: float = 0.0  # active/(active+idle) from /proc/stat deltas
    process_total_cpu_time_delta: float = 0.0
