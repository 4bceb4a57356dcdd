"""Resource layer: workload discovery from procfs (reference
``internal/resource/``)."""

from kepler_tpu_torch.resource.container import (
    container_info_from_cgroup_paths,
    container_info_from_proc,
)
from kepler_tpu_torch.resource.informer import (
    Containers,
    FeatureBatch,
    Pods,
    Processes,
    ResourceInformer,
    VirtualMachines,
)
from kepler_tpu_torch.resource.fast_procfs import (
    FastProcFSReader,
    make_proc_reader,
)
from kepler_tpu_torch.resource.procfs import ProcFSReader, ProcInfo, ProcReader
from kepler_tpu_torch.resource.types import (
    Container,
    ContainerRuntime,
    Hypervisor,
    Node,
    Pod,
    Process,
    VirtualMachine,
)
from kepler_tpu_torch.resource.vm import vm_info_from_proc

__all__ = [
    "Container",
    "ContainerRuntime",
    "Containers",
    "FastProcFSReader",
    "FeatureBatch",
    "Hypervisor",
    "Node",
    "Pod",
    "Pods",
    "ProcFSReader",
    "ProcInfo",
    "ProcReader",
    "Process",
    "Processes",
    "ResourceInformer",
    "VirtualMachine",
    "VirtualMachines",
    "container_info_from_cgroup_paths",
    "container_info_from_proc",
    "make_proc_reader",
    "vm_info_from_proc",
]
