"""A small FLAC encoder for tests: writes files whose every frame uses
the subframe types and channel modes a test asks for, so that a decoder
can be held to each of them.

    write_flac(path, samples, sr, method="lpc", stereo="mid_side")

`samples` are integers, [S] (mono) or [C, S]. Each subframe is CONSTANT
when its block holds one value (and `constant` is set), else `method`:
"verbatim", "fixed0".."fixed4" or "lpc" (least-squares coefficients of
`lpc_order`, quantized to `lpc_precision` bits). Residuals are Rice
coded in up to 2**`partition_order` partitions (4-bit parameters, or
5-bit with `rice5`); every third partition is written raw (the escape
code) when `escape` is set. With `wasted`, the low zero bits common to a
block are stripped (the wasted-bits flag). Stereo is "independent",
"left_side", "right_side" or "mid_side". Block sizes need not be powers
of two; the last block is whatever remains. STREAMINFO carries the MD5
of the samples, and frames carry their CRC-8 and CRC-16.
"""

from __future__ import annotations

import hashlib

import numpy as np

_STEREO = {"independent": 1, "left_side": 8, "right_side": 9, "mid_side": 10}
_SS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}


class _Bits:
    def __init__(self):
        self.parts: list[str] = []
        self.n = 0

    def put(self, value: int, n: int) -> None:
        if n:
            self.parts.append(format(value & ((1 << n) - 1), f"0{n}b"))
            self.n += n

    def signed(self, value: int, n: int) -> None:
        if n and not -(1 << (n - 1)) <= value < (1 << (n - 1)):
            raise ValueError(f"{value} does not fit {n} signed bits")
        self.put(value, n)

    def unary(self, q: int) -> None:
        self.parts.append("0" * q + "1")
        self.n += q + 1

    def align(self) -> None:
        self.put(0, -self.n % 8)

    def bytes(self) -> bytes:
        s = "".join(self.parts)
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def _crc(data: bytes, poly: int, width: int) -> int:
    crc, top, mask = 0, 1 << (width - 1), (1 << width) - 1
    for b in data:
        crc ^= b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else crc << 1
            crc &= mask
    return crc


def _utf8(v: int) -> list[int]:
    if v < 0x80:
        return [v]
    n = 2
    while v >= 1 << (5 * n + 1):
        n += 1
    out = []
    for _ in range(n - 1):
        out.append(0x80 | (v & 0x3F))
        v >>= 6
    return [((0xFF00 >> n) & 0xFF) | v] + out[::-1]


def _blocksize_code(bs: int) -> tuple[int, int, int]:
    """-> (4-bit code, extra bits, extra value)."""
    if bs == 192:
        return 1, 0, 0
    for k in range(4):
        if bs == 576 << k:
            return 2 + k, 0, 0
    for k in range(8):
        if bs == 256 << k:
            return 8 + k, 0, 0
    return (6, 8, bs - 1) if bs <= 256 else (7, 16, bs - 1)


def _rice(bits: _Bits, res: list[int], order: int, bs: int, porder: int,
          rice5: bool, escape: bool) -> None:
    po = porder
    while po and (bs % (1 << po) or (bs >> po) < order):
        po -= 1
    bits.put(1 if rice5 else 0, 2)
    bits.put(po, 4)
    plen, esc = (5, 31) if rice5 else (4, 15)
    idx = 0
    for p in range(1 << po):
        count = (bs >> po) - (order if p == 0 else 0)
        part = res[idx: idx + count]
        idx += count
        if escape and p % 3 == 2:
            width = max((max(abs(v) for v in part).bit_length() + 1) if part else 0, 1)
            bits.put(esc, plen)
            bits.put(width, 5)
            for v in part:
                bits.signed(v, width)
            continue
        u = [2 * v if v >= 0 else -2 * v - 1 for v in part]
        mean = sum(u) / max(len(u), 1)
        k = min(max(int(mean).bit_length() - 1, 0), esc - 1)
        bits.put(k, plen)
        for x in u:
            bits.unary(x >> k)
            bits.put(x, k)


def _fixed_residual(x: list[int], order: int) -> list[int]:
    d = list(x)
    for _ in range(order):
        d = [d[0]] + [d[i] - d[i - 1] for i in range(1, len(d))]
    return d[order:]


def _lpc(x: np.ndarray, order: int, precision: int):
    """Least-squares predictor, quantized: (coefficients, shift)."""
    xf = x.astype(np.float64)
    rows = np.stack([xf[order - 1 - j: len(xf) - 1 - j] for j in range(order)], 1)
    coef = np.linalg.lstsq(rows, xf[order:], rcond=None)[0] if len(rows) else np.zeros(order)
    cmax = float(np.abs(coef).max()) if coef.size else 0.0
    shift = precision - 1 - max(int(np.ceil(np.log2(cmax))) if cmax > 0 else 0, 0) - 1
    shift = int(min(max(shift, 0), 15))
    lim = 1 << (precision - 1)
    q = [int(np.clip(round(c * (1 << shift)), -lim, lim - 1)) for c in coef]
    return q, shift


def _subframe(bits: _Bits, x: np.ndarray, bps: int, method: str, *,
              constant: bool, wasted: bool, lpc_order: int, lpc_precision: int,
              partition_order: int, rice5: bool, escape: bool) -> None:
    xs = [int(v) for v in x]
    w = 0
    if wasted and any(xs):
        while all(v % (1 << (w + 1)) == 0 for v in xs):
            w += 1
        xs = [v >> w for v in xs]
    bps -= w
    bs = len(xs)
    if constant and all(v == xs[0] for v in xs):
        kind, order = 0, 0
    elif method == "verbatim":
        kind, order = 1, 0
    elif method.startswith("fixed"):
        order = int(method[5:])
        kind = 8 + order
    elif method == "lpc":
        order = lpc_order
        kind = 32 + order - 1
    else:
        raise ValueError(f"unknown method {method!r}")
    if order >= bs:  # too short a block to predict
        kind, order = 1, 0
    bits.put(0, 1)
    bits.put(kind, 6)
    bits.put(1 if w else 0, 1)
    if w:
        bits.unary(w - 1)
    if kind == 0:
        bits.signed(xs[0], bps)
        return
    if kind == 1:
        for v in xs:
            bits.signed(v, bps)
        return
    for v in xs[:order]:
        bits.signed(v, bps)
    if kind < 32:
        res = _fixed_residual(xs, order)
    else:
        coef, shift = _lpc(np.asarray(xs), order, lpc_precision)
        bits.put(lpc_precision - 1, 4)
        bits.signed(shift, 5)
        for c in coef:
            bits.signed(c, lpc_precision)
        res = [xs[i] - (sum(c * xs[i - 1 - j] for j, c in enumerate(coef)) >> shift)
               for i in range(order, bs)]
    _rice(bits, res, order, bs, partition_order, rice5, escape)


def write_flac(path: str, samples, sr: int, *, bps: int = 16,
               blocksize: int = 1152, method: str = "lpc",
               stereo: str = "independent", constant: bool = True,
               wasted: bool = True, lpc_order: int = 8, lpc_precision: int = 12,
               partition_order: int = 2, rice5: bool = False,
               escape: bool = False) -> bytes:
    """Write `samples` ([S] or [C, S] integers of `bps` bits) as FLAC;
    returns the STREAMINFO MD5."""
    x = np.asarray(samples, np.int64)
    x = x[None] if x.ndim == 1 else x
    ch, n = x.shape
    if ch != 2 and stereo != "independent":
        raise ValueError("a stereo mode needs two channels")
    if x.min(initial=0) < -(1 << (bps - 1)) or x.max(initial=0) >= 1 << (bps - 1):
        raise ValueError(f"samples do not fit {bps} bits")
    width = (bps + 7) // 8
    md5 = hashlib.md5(x.T.astype(f"<i{width}").tobytes()).digest()
    sizes = [min(blocksize, n - i) for i in range(0, n, blocksize)]

    info = _Bits()
    info.put(min(sizes[:-1] or sizes), 16)
    info.put(max(sizes), 16)
    info.put(0, 24)
    info.put(0, 24)
    info.put(sr, 20)
    info.put(ch - 1, 3)
    info.put(bps - 1, 5)
    info.put(n, 36)
    out = bytearray(b"fLaC")
    out += bytes([0x80, 0, 0, 34]) + info.bytes() + md5

    ch_code = _STEREO[stereo] if ch == 2 else ch - 1
    opts = dict(constant=constant, wasted=wasted, lpc_order=lpc_order,
                lpc_precision=lpc_precision, partition_order=partition_order,
                rice5=rice5, escape=escape)
    start = 0
    for fi, bs in enumerate(sizes):
        blk = x[:, start: start + bs]
        start += bs
        hdr = _Bits()
        code, extra_n, extra = _blocksize_code(bs)
        hdr.put(0x3FFE, 14)
        hdr.put(0, 2)
        hdr.put(code, 4)
        hdr.put(0, 4)
        hdr.put(ch_code, 4)
        hdr.put(_SS_CODES.get(bps, 0), 3)
        hdr.put(0, 1)
        for b in _utf8(fi):
            hdr.put(b, 8)
        hdr.put(extra, extra_n)
        head = hdr.bytes()
        frame = _Bits()
        for b in head + bytes([_crc(head, 0x07, 8)]):
            frame.put(b, 8)
        if ch_code == 8:
            chans = [(blk[0], bps), (blk[0] - blk[1], bps + 1)]
        elif ch_code == 9:
            chans = [(blk[0] - blk[1], bps + 1), (blk[1], bps)]
        elif ch_code == 10:
            chans = [((blk[0] + blk[1]) >> 1, bps), (blk[0] - blk[1], bps + 1)]
        else:
            chans = [(c, bps) for c in blk]
        for c, cbps in chans:
            _subframe(frame, c, cbps, method, **opts)
        frame.align()
        body = frame.bytes()
        out += body + _crc(body, 0x8005, 16).to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(bytes(out))
    return md5
