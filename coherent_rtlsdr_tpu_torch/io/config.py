"""Receiver config files — grammar parity with cconfigfile
(include/cconfigfile.h:32-72, examplecfg/four.cfg, examplecfg/URA21.cfg).

Format, one channel per line::

    # comment
    R :'SERIAL OF REF'     <- 'R' (or channel 0) marks the reference dongle
    1 :'SERIAL 1'          <- channel number defines rx-matrix row order
    2 :'SERIAL 2'

The reference reads the first two characters as the index field ('R' in
either position means the reference) and the serial between the first pair
of single quotes after the colon.
"""

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class ChannelDef:
    """sdrdefs analog (cconfigfile.h:25-28): devindex 0 == reference.

    ``gain_db`` extends the grammar with the per-channel tuner gain the
    reference left as future work (examplecfg/four.cfg:4): an optional
    ``gain=<dB>`` token after the serial. None = use the CLI default.
    """

    devindex: int
    serial: str
    gain_db: float = None


def parse_config(text: str) -> List[ChannelDef]:
    out: List[ChannelDef] = []
    for ln in text.splitlines():
        if not ln or ln[0] == "#":
            continue
        ids = ln[:2]
        if "R" in ids:
            devindex = 0
        else:
            try:
                devindex = int(ids)
            except ValueError:
                continue
        st = ln.find(":")
        if st < 0:
            continue
        st = ln.find("'", st + 1)
        end = ln.find("'", st + 1)
        if st < 0 or end < 0:
            continue
        gain = None
        tail = ln[end + 1 :]
        g = tail.find("gain=")
        if g >= 0:
            try:
                gain = float(tail[g + 5 :].split()[0])
            except (ValueError, IndexError):
                gain = None
        out.append(
            ChannelDef(devindex=devindex, serial=ln[st + 1 : end], gain_db=gain)
        )
    return out


def read_config(fname: str) -> List[ChannelDef]:
    with open(fname, "r") as f:
        return parse_config(f.read())


def get_refname(defs: List[ChannelDef]) -> str:
    """cconfigfile::get_refname (cconfigfile.h:61-71)."""
    for d in defs:
        if d.devindex == 0:
            return d.serial
    return ""


def signal_channels(defs: List[ChannelDef]) -> List[ChannelDef]:
    """Non-reference channels in rx-matrix order."""
    return sorted(
        (d for d in defs if d.devindex != 0), key=lambda d: d.devindex
    )
