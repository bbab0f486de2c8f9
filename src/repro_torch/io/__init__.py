"""Request-level I/O layer of the port: backends (`TorchBackend` on a
torch device, `NumpyBackend` host oracle), the coalescing `CodingEngine`,
the priority-classed shard-parallel front-end with admission control, the
degraded-read hot-block cache, and the Zipf / virtual-time workload
machinery that drives it (copies of `repro.io`)."""
from .backend import (BACKENDS, Backend, NumpyBackend, TorchBackend,
                      resolve_backend)
from .cache import CacheStats, HotBlockCache
from .engine import CodingEngine, FlushStats, OpHandle
# Priority/ClassStats canonically live in repro_torch.priority; re-exported
# here because the io layer is where most consumers meet them.
from .frontend import (ClassStats, MergedHandle, Priority, RequestFrontend,
                       RequestHandle, RequestShed, ScrubReport,
                       ServiceSample, ShardedFrontend)
from .workload import (Arrival, CompletedRequest, ServiceModel,
                       VirtualClock, ZipfWorkload, drive_open_loop)

__all__ = ["BACKENDS", "Backend", "NumpyBackend", "TorchBackend",
           "resolve_backend",
           "CacheStats", "HotBlockCache",
           "CodingEngine", "FlushStats", "OpHandle",
           "ClassStats", "MergedHandle", "Priority", "RequestFrontend",
           "RequestHandle", "RequestShed", "ScrubReport", "ServiceSample",
           "ShardedFrontend",
           "Arrival", "CompletedRequest", "ServiceModel", "VirtualClock",
           "ZipfWorkload", "drive_open_loop"]
