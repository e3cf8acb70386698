"""User-facing API: the Engine, the PBD1 server and client, and the
watchdog."""

from .client import PBDClient, RemoteWorld
from .engine import Engine
from .server import PBDServer
from .watchdog import Watchdog, WatchdogConfig

__all__ = ["Engine", "PBDServer", "PBDClient", "RemoteWorld", "Watchdog",
           "WatchdogConfig"]
