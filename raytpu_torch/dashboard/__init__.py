"""raytpu_torch.dashboard — server-rendered dashboard of a driver's
tree; the port of :mod:`raytpu.dashboard`."""

from raytpu_torch.dashboard.app import DashboardServer

__all__ = ["DashboardServer"]
