"""ctypes binding to NVML, the NVIDIA driver's management library.

The port's counterpart of ``tpu_docker_api/telemetry/shim.py`` (a ctypes
binding to the JAX package's native TPU shim library): here the native side
is the driver's own ``libnvidia-ml.so.1``, the library the reference's
detect-gpu sidecar wraps through go-nvml (SURVEY.md row 103). Nothing is
downloaded (no ``pynvml``). The library is loaded lazily, at the first
``load_nvml``, which raises ``OSError`` when it is absent, as ``load_shim``
does; callers (``telemetry.probe``) then fall back to a walk of
``/dev/nvidia*``.

Every symbol is the versioned one ``nvml.h`` maps its plain name to
(``nvmlInit_v2``, ``nvmlDeviceGetCount_v2``, ...). The structs are those
of ``nvml.h``; ``header_layout_errors`` holds them against a toolkit's
``nvml.h`` and names any size that differs, so a changed ABI is an error,
not garbage read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

#: the driver's NVML, found through the dynamic loader's search path
LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_INSUFFICIENT_SIZE = 7
#: nvmlDeviceGetMigMode's currentMode when MIG is on
NVML_DEVICE_MIG_ENABLE = 1

# buffer sizes of nvml.h (the _V2 sizes are the larger)
_DRIVER_VERSION_LEN = 80
_NAME_LEN = 96
_UUID_LEN = 96


class _Memory(ctypes.Structure):
    """nvmlMemory_t."""
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _Utilization(ctypes.Structure):
    """nvmlUtilization_t: percent of the last sample window."""
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class _ProcessInfo(ctypes.Structure):
    """nvmlProcessInfo_t as nvmlDeviceGetComputeRunningProcesses_v3 fills
    it: 24 bytes, 4 of them padding after ``pid``."""
    _fields_ = [("pid", ctypes.c_uint), ("usedGpuMemory", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


#: nvml.h typedef name → the binding's struct
STRUCTS = {"nvmlMemory_t": _Memory, "nvmlUtilization_t": _Utilization,
           "nvmlProcessInfo_t": _ProcessInfo}

_C_TYPES = {"unsigned int": ctypes.c_uint,
            "unsigned long long": ctypes.c_ulonglong}


def header_layout_errors(header: str) -> list[str]:
    """Hold each struct of ``STRUCTS`` against its typedef in the text of
    an ``nvml.h``: one message for each whose field names or size differ
    (a typedef missing from the header is one too). Empty = same ABI."""
    text = re.sub(r"/\*.*?\*/", "", header, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    errs = []
    for typedef, ours in STRUCTS.items():
        # "} nvmlProcessInfo_v2_t, nvmlProcessInfo_t;" names one struct
        # twice (CUDA 12.8's nvml.h)
        m = re.search(r"typedef\s+struct\s+\w*\s*\{([^}]*)\}"
                      r"[\w\s,]*\b" + re.escape(typedef) + r"\b[\w\s,]*;",
                      text)
        if m is None:
            errs.append(f"{typedef}: not in the header")
            continue
        fields = []
        for decl in m.group(1).split(";"):
            decl = " ".join(decl.split())
            if not decl:
                continue
            ctype, _, name = decl.rpartition(" ")
            if ctype not in _C_TYPES:
                errs.append(f"{typedef}: field {decl!r} of a type the "
                            f"binding does not map")
                break
            fields.append((name, _C_TYPES[ctype]))
        else:
            theirs = type("Header" + typedef, (ctypes.Structure,),
                          {"_fields_": fields})
            names = [f[0] for f in fields]
            want = [f[0] for f in ours._fields_]
            if names != want or ctypes.sizeof(theirs) != ctypes.sizeof(ours):
                errs.append(
                    f"{typedef}: the header has {names} in "
                    f"{ctypes.sizeof(theirs)} bytes, the binding {want} in "
                    f"{ctypes.sizeof(ours)} bytes")
    return errs


class NVMLError(RuntimeError):
    """An NVML call returned an error; ``code`` is its nvmlReturn_t."""

    def __init__(self, call: str, code: int, text: str) -> None:
        super().__init__(f"{call}: NVML error {code}: {text}")
        self.code = code


@dataclasses.dataclass
class ChipMetrics:
    """``shim.py``'s ChipMetrics, read from NVML, plus what a GPU has:
    its UUID, product name and enforced power limit."""
    chip_id: int
    device_path: str
    hbm_total: int
    hbm_used: int
    duty_cycle: float
    pid: int
    uuid: str
    name: str
    power_limit_w: float


class Nvml:
    """An initialised NVML. ``nvmlInit_v2`` runs once, here; NVML stays
    initialised for the life of the process, as a daemon's sidecar is."""

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        uint_p = ctypes.POINTER(ctypes.c_uint)
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        sigs = {
            "nvmlInit_v2": [],
            "nvmlSystemGetDriverVersion": [ctypes.c_char_p, ctypes.c_uint],
            "nvmlDeviceGetCount_v2": [uint_p],
            "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, handle_p],
            "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint],
            "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint],
            "nvmlDeviceGetMinorNumber": [ctypes.c_void_p, uint_p],
            "nvmlDeviceGetMemoryInfo": [ctypes.c_void_p,
                                        ctypes.POINTER(_Memory)],
            "nvmlDeviceGetUtilizationRates": [ctypes.c_void_p,
                                              ctypes.POINTER(_Utilization)],
            "nvmlDeviceGetEnforcedPowerLimit": [ctypes.c_void_p, uint_p],
            "nvmlDeviceGetComputeRunningProcesses_v3": [
                ctypes.c_void_p, uint_p, ctypes.POINTER(_ProcessInfo)],
            "nvmlDeviceGetMigMode": [ctypes.c_void_p, uint_p, uint_p],
        }
        for sym, argtypes in sigs.items():
            fn = getattr(lib, sym)  # AttributeError names a missing symbol
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        lib.nvmlErrorString.restype = ctypes.c_char_p
        self._call("nvmlInit_v2")

    def error_string(self, code: int) -> str:
        text = self._lib.nvmlErrorString(code)
        return text.decode(errors="replace") if text else "unknown error"

    def _call(self, sym: str, *args) -> int:
        rc = getattr(self._lib, sym)(*args)
        if rc != NVML_SUCCESS:
            raise NVMLError(sym, rc, self.error_string(rc))
        return rc

    def _string(self, sym: str, size: int, *args) -> str:
        buf = ctypes.create_string_buffer(size)
        self._call(sym, *args, buf, size)
        return buf.value.decode()

    def driver_version(self) -> str:
        return self._string("nvmlSystemGetDriverVersion",
                            _DRIVER_VERSION_LEN)

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def _handle(self, index: int) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def mig_enabled(self, index: int) -> bool:
        """Whether MIG is on (then UUIDs name instances, not GPUs);
        False where the part has no MIG."""
        cur, pending = ctypes.c_uint(), ctypes.c_uint()
        rc = self._lib.nvmlDeviceGetMigMode(self._handle(index),
                                            ctypes.byref(cur),
                                            ctypes.byref(pending))
        if rc == NVML_ERROR_NOT_SUPPORTED:
            return False
        if rc != NVML_SUCCESS:
            raise NVMLError("nvmlDeviceGetMigMode", rc, self.error_string(rc))
        return cur.value == NVML_DEVICE_MIG_ENABLE

    def compute_processes(self, index: int) -> list[tuple[int, int]]:
        """(pid, used bytes) of each compute process on the GPU. The
        list is sized by asking: NVML_ERROR_INSUFFICIENT_SIZE returns the
        count it needs, and the buffer grows to it (with room for
        processes that start in between) until the call fits."""
        h = self._handle(index)
        fn = "nvmlDeviceGetComputeRunningProcesses_v3"
        cap = 0
        for _ in range(8):
            count = ctypes.c_uint(cap)
            buf = (_ProcessInfo * cap)() if cap else None
            rc = getattr(self._lib, fn)(h, ctypes.byref(count), buf)
            if rc == NVML_SUCCESS:
                return [] if buf is None else [
                    (buf[i].pid, buf[i].usedGpuMemory)
                    for i in range(count.value)]
            if rc != NVML_ERROR_INSUFFICIENT_SIZE:
                raise NVMLError(fn, rc, self.error_string(rc))
            cap = count.value + 4
        raise NVMLError(fn, NVML_ERROR_INSUFFICIENT_SIZE,
                        "the process list kept outgrowing its buffer")

    def chip_metrics(self, index: int) -> ChipMetrics:
        h = self._handle(index)
        minor, limit_mw = ctypes.c_uint(), ctypes.c_uint()
        mem, util = _Memory(), _Utilization()
        self._call("nvmlDeviceGetMinorNumber", h, ctypes.byref(minor))
        self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(mem))
        self._call("nvmlDeviceGetUtilizationRates", h, ctypes.byref(util))
        self._call("nvmlDeviceGetEnforcedPowerLimit", h,
                   ctypes.byref(limit_mw))
        procs = self.compute_processes(index)
        return ChipMetrics(
            chip_id=index,
            device_path=f"/dev/nvidia{minor.value}",
            hbm_total=int(mem.total),
            hbm_used=int(mem.used),
            duty_cycle=float(util.gpu),
            pid=procs[0][0] if procs else 0,
            uuid=self._string("nvmlDeviceGetUUID", _UUID_LEN, h),
            name=self._string("nvmlDeviceGetName", _NAME_LEN, h),
            power_limit_w=limit_mw.value / 1000.0,
        )


@functools.lru_cache(maxsize=None)
def _load(path: str) -> Nvml:
    return Nvml(ctypes.CDLL(path))


def load_nvml(path: str = "") -> Nvml:
    """The initialised NVML of ``path`` (default ``LIBRARY``), loaded
    once a process; raises OSError when the library is absent."""
    return _load(path or LIBRARY)
