"""Virtual-machine (hypervisor process) detection.

Reference parity: ``internal/resource/vm.go`` — QEMU/KVM detection via
cmdline regex (:15); VM id from ``-uuid``, name from ``-name guest=...``;
deterministic fallback id from a hash of the cmdline (:103-109).
"""

from __future__ import annotations

import hashlib
import re

from kepler_tpu_torch.resource.procfs import ProcInfo
from kepler_tpu_torch.resource.types import Hypervisor, VirtualMachine

_QEMU_RE = re.compile(r"(bin/qemu-system-\w+|libexec/qemu-kvm)")


def _extract_flag(cmdline: list[str], flag: str) -> str:
    # "-name foo" and "-name=foo" forms (reference vm_test.go covers both)
    for i, arg in enumerate(cmdline):
        if arg == flag and i + 1 < len(cmdline):
            return cmdline[i + 1]
        if arg.startswith(flag + "="):
            return arg.split("=", 1)[1]
    return ""


def _guest_name(name_arg: str) -> str:
    # "-name guest=myvm,debug-threads=on" → "myvm"; bare "-name foo" → "foo"
    for part in name_arg.split(","):
        if part.startswith("guest="):
            return part.split("=", 1)[1]
    if "=" not in name_arg:
        return name_arg
    return ""


def vm_info_from_cmdline(cmdline: list[str]) -> VirtualMachine | None:
    """QEMU/KVM detection from an already-read cmdline (the batched
    first-sight path hands contents over; no file IO here)."""
    if not cmdline:
        return None
    joined = " ".join(cmdline)
    if not _QEMU_RE.search(joined):
        return None
    vm_id = _extract_flag(cmdline, "-uuid")
    name = _guest_name(_extract_flag(cmdline, "-name"))
    if not vm_id:
        if name:
            vm_id = name
        else:  # deterministic fallback hash (reference vm.go:103-109)
            vm_id = hashlib.sha256(joined.encode()).hexdigest()[:16]
    return VirtualMachine(id=vm_id, name=name or vm_id,
                          hypervisor=Hypervisor.KVM)


def vm_info_from_proc(proc: ProcInfo) -> VirtualMachine | None:
    try:
        cmdline = proc.cmdline()
    except OSError:
        return None
    return vm_info_from_cmdline(cmdline)
