"""The card's own energy counter, through NVML and ``ctypes``.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the card
has used since its driver loaded; the benchmark reads it at the window's
start and end.  The handle is the card the run uses, found by the PCI bus
id PyTorch gives for it.  ``libnvidia-ml.so.1`` ships with the driver;
nothing is installed.
"""

from __future__ import annotations

import ctypes


class NvmlError(RuntimeError):
    pass


class Card:
    """One card's NVML handle: energy counter, power limit."""

    def __init__(self, props):
        try:
            self._lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as e:
            raise NvmlError(f"libnvidia-ml.so.1: {e}") from e
        self._call("nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        self.bus_id = (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
                       f"{props.pci_device_id:02X}.0")
        self._call("nvmlDeviceGetHandleByPciBusId_v2", self.bus_id.encode(),
                   ctypes.byref(self._handle))

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != 0:
            raise NvmlError(f"{name} returned NVML error {rc}")

    def energy_j(self) -> float:
        mj = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self._handle,
                   ctypes.byref(mj))
        return mj.value / 1e3

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetEnforcedPowerLimit", self._handle,
                   ctypes.byref(mw))
        return mw.value / 1e3

    def close(self) -> None:
        self._lib.nvmlShutdown()
