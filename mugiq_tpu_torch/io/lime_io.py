"""ILDG/LIME gauge configuration IO (port of mugiq_tpu.io.lime_io and of
the pure-Python record walker of mugiq_tpu.io.native).

A LIME file is a sequence of records, each a 144-byte big-endian header
(magic 0x456789AB, version, flags, data length, 128-byte type string)
followed by its data padded to 8 bytes.  An ILDG gauge file holds an
``ildg-format`` XML record (dimensions, precision) and an
``ildg-binary-data`` record:

    site-major (x fastest), per site mu = x, y, z, t; 3x3 row-major
    complex, big-endian IEEE 64 (or 32) floats,

returned in the [4, T, Z, Y, X, 3, 3] layout.  The writer exists for
fixtures and interchange.
"""

import re
import struct
from typing import Dict, List, Tuple

import numpy as np

LIME_MAGIC = 0x456789AB
_HDR_BYTES = 144

_ILDG_FORMAT_XML = """<?xml version="1.0" encoding="UTF-8"?>
<ildgFormat xmlns="http://www.lqcd.org/ildg">
  <version>1.0</version>
  <field>su3gauge</field>
  <precision>{prec}</precision>
  <lx>{lx}</lx><ly>{ly}</ly><lz>{lz}</lz><lt>{lt}</lt>
</ildgFormat>"""


def _lime_header(msg_begin: bool, msg_end: bool, length: int,
                 rectype: str) -> bytes:
    bits = (0x8000 if msg_begin else 0) | (0x4000 if msg_end else 0)
    t = rectype.encode("ascii")[:128]
    return (struct.pack(">IHHQ", LIME_MAGIC, 1, bits, length)
            + t + b"\0" * (128 - len(t)))


def lime_records(path: str) -> List[Tuple[str, int, int]]:
    """[(type, data offset, data length)] of each LIME record in the file."""
    out = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            hdr = f.read(_HDR_BYTES)
            if len(hdr) < _HDR_BYTES:
                break
            if int.from_bytes(hdr[:4], "big") != LIME_MAGIC:
                break
            dlen = int.from_bytes(hdr[8:16], "big")
            t = hdr[16:144].split(b"\0")[0].decode("ascii", "replace")
            out.append((t, pos + _HDR_BYTES, dlen))
            pos += _HDR_BYTES + ((dlen + 7) & ~7)
            f.seek(pos)
    return out


def read_record(path: str, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise ValueError(f"{path}: LIME record at {offset} is truncated "
                         f"({len(data)} of {length} bytes)")
    return data


def write_ildg_gauge(path: str, U: np.ndarray, double: bool = True) -> None:
    """Write [4, T, Z, Y, X, 3, 3] complex as an ILDG LIME file."""
    U = np.asarray(U)
    _, T, Z, Y, X = U.shape[:5]
    xml = _ILDG_FORMAT_XML.format(prec=64 if double else 32,
                                  lx=X, ly=Y, lz=Z, lt=T).encode()
    u = np.moveaxis(U, 0, 4)                       # [T, Z, Y, X, 4, 3, 3]
    flat = np.empty(u.size * 2, dtype=np.float64)
    flat[0::2] = u.reshape(-1).real
    flat[1::2] = u.reshape(-1).imag
    payload = flat.astype(">f8" if double else ">f4").tobytes()
    with open(path, "wb") as f:
        for rectype, data, begin, end in (
                ("ildg-format", xml, True, False),
                ("ildg-binary-data", payload, False, True)):
            f.write(_lime_header(begin, end, len(data), rectype))
            f.write(data)
            f.write(b"\0" * ((-len(data)) % 8))


def read_ildg_gauge(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Read an ILDG LIME gauge file -> (U [4, T, Z, Y, X, 3, 3], info)."""
    recs = lime_records(path)
    if not recs:
        raise ValueError(f"{path}: no LIME records found")
    fmt = next((r for r in recs if r[0] == "ildg-format"), None)
    data = next((r for r in recs if r[0] == "ildg-binary-data"), None)
    if data is None:
        raise ValueError(f"{path}: no ildg-binary-data record")
    if fmt is None:
        raise ValueError(f"{path}: lattice dims not found in ildg-format")
    xml = read_record(path, fmt[1], fmt[2]).decode("ascii", "replace")

    def grab(tag):
        m = re.search(rf"<{tag}>\s*(\d+)\s*</{tag}>", xml)
        return int(m.group(1)) if m else None

    dims = tuple(grab(t) for t in ("lx", "ly", "lz", "lt"))
    if None in dims:
        raise ValueError(f"{path}: lattice dims not found in ildg-format")
    prec = grab("precision") or 64
    raw = read_record(path, data[1], data[2])
    vals = np.frombuffer(raw, dtype=">f8" if prec == 64 else ">f4")
    vals = vals.astype(np.float64)
    lx, ly, lz, lt = dims
    u = (vals[0::2] + 1j * vals[1::2]).reshape(lt, lz, ly, lx, 4, 3, 3)
    return np.moveaxis(u, 4, 0), {"ildg-format": xml}
