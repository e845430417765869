"""The console command grammar — the reference's one and only control
protocol (include/console.h:40-70, src/console.cc:334-430). The remote ZMQ
control plane speaks exactly these text commands (the MATLAB client sends
strings like ``"fcenter 868000000"`` and ``"request re"``, zmqsdr.c:152-181),
so this parser IS the network protocol.

Commands (console.cc handlers):
    help                      print command list
    fs [hz]                   get/set sample rate (forces full resync)
    fcenter [hz]              get/retune center frequency (1-1800 MHz check)
    list [all]                capturing channels / full USB inventory
    add <serial>              hot-add a device
    del <serial>              hot-remove a device
    status                    n-synced + per-device lag:mag table
    log                       drain captured stderr
    request re|rd|lag|sync    refnoise on/off, force lag est, force resync
    phase                     one-shot phase table vs reference
    quit                      shut down
"""

import dataclasses
import enum
import math
from typing import Callable, Dict, List, Optional

from coherent_rtlsdr_tpu_torch.constants import FCENTER_MAX_HZ, FCENTER_MIN_HZ


class Command(enum.Enum):
    HELP = "help"
    FS = "fs"
    ADD = "add"
    DEL = "del"
    STATUS = "status"
    LIST = "list"
    NOP = "nop"
    LOG = "log"
    QUIT = "quit"
    FCENTER = "fcenter"
    REQUEST = "request"
    PHASE = "phase"


@dataclasses.dataclass(frozen=True)
class ParsedCommand:
    command: Command
    options: str


def parse_command(line: str) -> ParsedCommand:
    """cconsole::parsecmd + getoptionstr (console.cc:334-355): the first
    whitespace-delimited word selects the command (unknown -> nop), the rest
    is the options string."""
    line = line.strip()
    if not line:
        return ParsedCommand(Command.NOP, "")
    parts = line.split(None, 1)
    try:
        cmd = Command(parts[0])
    except ValueError:
        cmd = Command.NOP
    return ParsedCommand(cmd, parts[1] if len(parts) > 1 else "")


HELP_TEXT = (
    "commands: help fs add del status list log quit fcenter request phase"
)


class ConsoleDispatcher:
    """Maps parsed commands onto a controller object (the runtime server).

    The controller duck-type (subset of what csdrdevice/ccoherent/crefnoise
    expose to the console):
        get_fs() / set_fs(hz)
        get_fcenter() / set_fcenter(hz)
        status() -> str
        list_channels(all=...) -> str
        phase_table() -> str
        set_refnoise(bool)
        request_lag() / request_sync()
        add_channel(serial) / del_channel(serial)
        drain_log() -> str
        shutdown()
    """

    def __init__(self, controller):
        self.c = controller

    def dispatch(self, line: str) -> str:
        p = parse_command(line)
        c = self.c
        if p.command == Command.HELP:
            return HELP_TEXT
        if p.command == Command.NOP:
            return ""
        if p.command == Command.QUIT:
            c.shutdown()
            return "bye"
        if p.command == Command.FS:
            if p.options:
                try:
                    fs = float(p.options)
                except ValueError:
                    return f"invalid fs: {p.options}"
                # sanity range: RTL2832-class rates (fuzz guard — the
                # reference sets whatever arrives, console.cc:160-167)
                if not (math.isfinite(fs) and 1e3 <= fs <= 1e9):
                    return f"fs out of range: {p.options}"
                ok = c.set_fs(fs)  # forces resync (console.cc:168)
                if ok is False:  # hardware refused; server kept the old rate
                    return f"fs change FAILED, still {c.get_fs():.0f} (see log)"
                return f"fs set to {fs:.0f}"
            return f"fs = {c.get_fs():.0f}"
        if p.command == Command.FCENTER:
            if p.options:
                try:
                    fc = float(p.options)
                except ValueError:
                    return f"invalid fcenter: {p.options}"
                # Range check 1-1800 MHz (console.cc:189).
                if not (FCENTER_MIN_HZ <= fc <= FCENTER_MAX_HZ):
                    return f"fcenter out of range: {fc:.0f}"
                ok = c.set_fcenter(fc)
                if ok is False:  # a dongle retune failed
                    return (
                        f"fcenter retune FAILED, still "
                        f"{c.get_fcenter():.0f} (see log)"
                    )
                return f"fcenter set to {fc:.0f}"
            return f"fcenter = {c.get_fcenter():.0f}"
        if p.command == Command.STATUS:
            return c.status()
        if p.command == Command.LIST:
            return c.list_channels(all=(p.options.strip() == "all"))
        if p.command == Command.PHASE:
            return c.phase_table()
        if p.command == Command.LOG:
            return c.drain_log()
        if p.command == Command.ADD:
            return c.add_channel(p.options.strip())
        if p.command == Command.DEL:
            return c.del_channel(p.options.strip())
        if p.command == Command.REQUEST:
            opt = p.options.strip()
            # console.cc:271-292
            if opt == "re":
                c.set_refnoise(True)
                return "enable refnoise"
            if opt == "rd":
                c.set_refnoise(False)
                return "disable refnoise"
            if opt == "lag":
                msg = c.request_lag()
                return msg or "lag requested"
            if opt == "sync":
                c.request_sync()
                return "resync requested"
            return f"unknown request: {opt}"
        return ""
