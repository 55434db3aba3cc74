"""Numpy encoders for the JPEG and PNG formats beyond baseline that the
port's readers decode, for the CPU tests and ``chip_smoke.py`` (pytest does
not collect this module).

`write_jpeg` writes a JPEG from quantised coefficients (or, for lossless,
samples) with any frame and any scan script: sequential or progressive,
Huffman (tables built from the scan's own symbol counts, ITU T.81 Annex K.2)
or arithmetic coding (the QM coder of Annex D with the statistics of
F.1.4.4 and G.1.3, DAC conditioning), lossless (Annex H) at precisions 2-16
with any predictor and point transform, any restart interval, any APPn
segments (JFIF, Adobe with its transform flag).  `jpeg_frame` builds the
coefficients from sample planes.  `encode_png_any` writes every PNG colour
type at every depth, Adam7-interlaced or not, with ancillary chunks.

Each encoder returns the bytes; `reconstruct` gives what a decoder must
rebuild of a plane: libjpeg's islow IDCT of the final coefficients (8-bit
frames), or the lossless samples.  `corpus_file` and `damaged_file` make
the files ``chip_smoke.py`` phase 18 checks, `reencode_jpeg` /
`reencode_png` the variants of its training trees.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from torch_datasets_tree import LUMA_Q, ZIGZAG, _fdct_matrix, _segment, idct_islow, quant_table
from torch_mura_tree import CHANNELS, _chunk, filter_row

# jaricom.c's jpeg_aritab: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7
# | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
ARITAB = [
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171]
FIXED = 113
ZZ = ZIGZAG.tolist()

SOF = {"baseline": 0xC0, "extended": 0xC1, "progressive": 0xC2, "lossless": 0xC3,
       "arith": 0xC9, "arith-progressive": 0xCA}


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


JFIF = _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment with the colour transform flag (0 none / RGB
    or CMYK, 1 YCbCr, 2 YCCK)."""
    return _marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


# ---------------------------------------------------------------------------
# Huffman tables from symbol counts (Annex K.2, jchuff.c's
# jpeg_gen_optimal_table)
# ---------------------------------------------------------------------------

def optimal_table(freq) -> tuple[bytes, bytes]:
    """(16 code counts, symbols) of a length-limited Huffman code for the
    symbol counts ``freq`` (257 entries; every symbol used gets a code)."""
    freq = [int(f) for f in freq[:256]] + [1]
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 60
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 60
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                                  # drop the reserved code point
    vals = [s for size in range(1, 33) for s in range(256) if codesize[s] == size]
    return bytes(bits[1:17]), bytes(vals)


def _codes(counts: bytes, vals: bytes) -> dict:
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _extra(v: int) -> tuple[int, int]:
    """(category, the low bits that follow it) of a signed value."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


# ---------------------------------------------------------------------------
# The QM arithmetic coder (Annex D, jcarith.c)
# ---------------------------------------------------------------------------

class QMEncoder:
    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, stats, i, val):
        sv = stats[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _flush_stacked(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            while self.sc:
                self._emit(0xFF)
                self._emit(0)
                self.sc -= 1

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        out = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return out


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

class Frame:
    """Components (id, h, v, quant table slot) with their coefficients
    (block rows, block columns, 64) int64 in natural order, covering the
    MCU-padded area, or for lossless their samples (rows, columns)."""

    def __init__(self, width, height, comps, precision=8, lossless=False):
        self.width, self.height, self.comps = width, height, comps
        self.precision, self.lossless = precision, lossless
        self.hmax = max(c["h"] for c in comps)
        self.vmax = max(c["v"] for c in comps)
        unit = 1 if lossless else 8
        self.mcus_x = -(-width // (unit * self.hmax))
        self.mcus_y = -(-height // (unit * self.vmax))

    def comp_size(self, c):
        """(columns, rows) of component ``c``'s samples."""
        comp = self.comps[c]
        return (-(-self.width * comp["h"] // self.hmax), -(-self.height * comp["v"] // self.vmax))

    def units(self, scan_comps):
        """MCUs of the scan: lists of (component, row, column) of its blocks
        (or samples, lossless)."""
        unit = 1 if self.lossless else 8
        if len(scan_comps) == 1:
            c = scan_comps[0]
            w, h = self.comp_size(c)
            bw, bh = -(-w // unit), -(-h // unit)
            return [[(c, y, x)] for y in range(bh) for x in range(bw)]
        out = []
        for my in range(self.mcus_y):
            for mx in range(self.mcus_x):
                mcu = []
                for c in scan_comps:
                    comp = self.comps[c]
                    for by in range(comp["v"]):
                        for bx in range(comp["h"]):
                            mcu.append((c, my * comp["v"] + by, mx * comp["h"] + bx))
                out.append(mcu)
        return out


def _shift(v, al):
    """The point transform of an AC coefficient: |v| >> al with v's sign."""
    return -((-v) >> al) if v < 0 else v >> al


class HuffmanScan:
    """Symbols of one Huffman-coded scan, per restart interval: (table,
    symbol, bits, bit count) with table None for raw bits."""

    def __init__(self, comps, ss, se, ah, al, progressive):
        self.comps, self.ss, self.se, self.ah, self.al = comps, ss, se, ah, al
        self.progressive = progressive
        self.start_interval()

    def start_interval(self):
        self.last = {c: 0 for c in self.comps}
        self.eobrun, self.be = 0, []
        self.events = []

    def sym(self, table, s, bits=0, n=0):
        self.events.append((table, s, bits, n))

    def raw(self, bits, n):
        if n:
            self.events.append((None, 0, bits, n))

    def flush_eobrun(self):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.sym(("ac", self.comps[0]), n << 4, self.eobrun & ((1 << n) - 1), n)
            self.eobrun = 0
            for b in self.be:
                self.raw(b, 1)
            self.be = []

    def end_interval(self):
        self.flush_eobrun()
        events = self.events
        self.start_interval()
        return events

    def block(self, c, blk):
        blk = blk.tolist()
        if self.ss == 0:
            if self.ah == 0 or not self.progressive:
                t = blk[0] >> self.al
                s, bits = _extra(t - self.last[c])
                self.last[c] = t
                self.sym(("dc", c), s, bits, s)
            else:
                self.raw((blk[0] >> self.al) & 1, 1)
            if self.progressive:
                return
            self.sequential_ac(c, blk)
        elif self.ah == 0:
            self.ac_first(c, blk)
        else:
            self.ac_refine(c, blk)

    def sequential_ac(self, c, blk):
        r = 0
        for k in range(1, 64):
            v = int(blk[ZZ[k]])
            if v == 0:
                r += 1
                continue
            while r > 15:
                self.sym(("ac", c), 0xF0)
                r -= 16
            s, bits = _extra(v)
            self.sym(("ac", c), (r << 4) | s, bits, s)
            r = 0
        if r:
            self.sym(("ac", c), 0)

    def ac_first(self, c, blk):
        r = 0
        for k in range(self.ss, self.se + 1):
            v = _shift(int(blk[ZZ[k]]), self.al)
            if v == 0:
                r += 1
                continue
            self.flush_eobrun()
            while r > 15:
                self.sym(("ac", c), 0xF0)
                r -= 16
            s, bits = _extra(v)
            self.sym(("ac", c), (r << 4) | s, bits, s)
            r = 0
        if r:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.flush_eobrun()

    def ac_refine(self, c, blk):
        absv = [abs(int(blk[ZZ[k]])) >> self.al for k in range(64)]
        eob = 0
        for k in range(self.ss, self.se + 1):
            if absv[k] == 1:
                eob = k
        r, br = 0, []
        for k in range(self.ss, self.se + 1):
            t = absv[k]
            if t == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.flush_eobrun()
                self.sym(("ac", c), 0xF0)
                r -= 16
                for b in self.be + br:
                    self.raw(b, 1)
                self.be, br = [], []
            if t > 1:
                br.append(t & 1)
                continue
            self.flush_eobrun()
            self.sym(("ac", c), (r << 4) | 1, 0 if blk[ZZ[k]] < 0 else 1, 1)
            for b in self.be + br:
                self.raw(b, 1)
            self.be, br, r = [], [], 0
        if r or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 900:
                self.flush_eobrun()


class ArithScan:
    """One arithmetic-coded scan (jcarith.c), statistics reset at each
    restart."""

    def __init__(self, comps, ss, se, ah, al, progressive, dac):
        self.comps, self.ss, self.se, self.ah, self.al = comps, ss, se, ah, al
        self.progressive, self.dac = progressive, dac
        self.qm = QMEncoder()
        self.start_interval()

    def start_interval(self):
        self.dc_stats = {c: [0] * 64 for c in self.comps}
        self.ac_stats = {c: [0] * 256 for c in self.comps}
        self.fixed = [0] * 114
        self.fixed[FIXED] = FIXED
        self.last = {c: 0 for c in self.comps}
        self.ctx = {c: 0 for c in self.comps}

    def end_interval(self):
        out = self.qm.finish()
        self.start_interval()
        return out

    def _e(self, st, i, v):
        self.qm.encode(st, i, v)

    def _fixed(self, v):
        self.qm.encode(self.fixed, FIXED, v)

    def _magnitude(self, st, i, v, ac_k=None, k=0, dc_base=None):
        """Figures F.8 and F.9 for |value| - 1 = v at bin ``i``; returns the
        magnitude category bound m."""
        m = 0
        if v:
            self._e(st, i, 1)
            m = 1
            v2 = v
            if ac_k is None:
                i = 20
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    self._e(st, i, 1)
                    m <<= 1
                    i += 1
            else:
                v2 >>= 1
                if v2:
                    self._e(st, i, 1)
                    m <<= 1
                    i = 189 if k <= ac_k else 217
                    while True:
                        v2 >>= 1
                        if not v2:
                            break
                        self._e(st, i, 1)
                        m <<= 1
                        i += 1
        self._e(st, i, 0)
        i += 14
        mm = m
        while True:
            mm >>= 1
            if not mm:
                break
            self._e(st, i, 1 if mm & v else 0)
        return m

    def dc_value(self, c, t):
        st = self.dc_stats[c]
        i = self.ctx[c]
        v = t - self.last[c]
        if v == 0:
            self._e(st, i, 0)
            self.ctx[c] = 0
            return
        self.last[c] = t
        self._e(st, i, 1)
        if v > 0:
            self._e(st, i + 1, 0)
            i += 2
            self.ctx[c] = 4
        else:
            v = -v
            self._e(st, i + 1, 1)
            i += 3
            self.ctx[c] = 8
        lo, hi = self.dac["dc"].get(c, (0, 1))
        m = self._magnitude(st, i, v - 1)
        if m < (1 << lo) >> 1:
            self.ctx[c] = 0
        elif m > (1 << hi) >> 1:
            self.ctx[c] += 8

    def block(self, c, blk):
        blk = blk.tolist()
        if self.ss == 0:
            if self.progressive and self.ah:
                self._fixed((blk[0] >> self.al) & 1)
            else:
                self.dc_value(c, int(blk[0]) >> self.al)
            if self.progressive:
                return
            self.ac(c, blk, 1, 63, 0)
        elif self.ah == 0:
            self.ac(c, blk, self.ss, self.se, self.al)
        else:
            self.ac_refine(c, blk)

    def ac(self, c, blk, ss, se, al):
        st = self.ac_stats[c]
        kx = self.dac["ac"].get(c, 5)
        vals = [_shift(int(blk[ZZ[k]]), al) for k in range(64)]
        ke = se
        while ke > 0 and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            self._e(st, i, 0)
            while vals[k] == 0:
                self._e(st, i + 1, 0)
                i += 3
                k += 1
            v = vals[k]
            self._e(st, i + 1, 1)
            self._fixed(0 if v > 0 else 1)
            self._magnitude(st, i + 2, abs(v) - 1, kx, k)
            k += 1
        if k <= se:
            self._e(st, 3 * (k - 1), 1)

    def ac_refine(self, c, blk):
        st = self.ac_stats[c]
        vals = [int(blk[ZZ[k]]) for k in range(64)]
        cur = [abs(v) >> self.al for v in vals]
        ke = self.se
        while ke > 0 and cur[ke] == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (abs(vals[kex]) >> self.ah) == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                self._e(st, i, 0)
            while True:
                if cur[k]:
                    if cur[k] >> 1:
                        self._e(st, i + 2, cur[k] & 1)
                    else:
                        self._e(st, i + 1, 1)
                        self._fixed(0 if vals[k] > 0 else 1)
                    break
                self._e(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= self.se:
            self._e(st, 3 * (k - 1), 1)


def lossless_differences(samples, precision, psv, pt, restart_rows=0):
    """(rows, cols) int differences modulo 2^16 (as -32767..32768) of a
    lossless scan of one component, the predictor reset at each restart
    (every ``restart_rows`` rows)."""
    x = samples.astype(np.int64) >> pt
    h, w = x.shape
    ra = np.zeros_like(x)
    rb = np.zeros_like(x)
    rc = np.zeros_like(x)
    ra[:, 1:], rb[1:], rc[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
    pred[:, 0] = rb[:, 0]                                    # the first column: the row above
    first = np.zeros(h, bool)
    first[::restart_rows or h] = True
    pred[first, 1:] = ra[first, 1:]                          # a first row: the left sample
    pred[first, 0] = 1 << (precision - pt - 1)
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def write_jpeg(frame: Frame, quant: dict, scans, coding="huffman", progressive=False,
               restart=0, app=(JFIF,), dac=None, sof=None, psv=1, pt=0) -> bytes:
    """JPEG bytes of ``frame`` with the scan script ``scans``: (component
    indices, Ss, Se, Ah, Al) each (lossless: (component indices,)).
    ``coding`` "huffman" or "arith"; ``dac`` {"dc": {comp: (L, U)}, "ac":
    {comp: Kx}} for the DAC segment; ``restart`` MCUs a restart interval."""
    dac = dac or {"dc": {}, "ac": {}}
    if frame.lossless and coding == "arith":
        raise ValueError("no arithmetic-coded lossless encoder (libjpeg-turbo decodes none)")
    if sof is None:
        if frame.lossless:
            sof = SOF["lossless"]
        elif coding == "arith":
            sof = SOF["arith-progressive" if progressive else "arith"]
        else:
            sof = SOF["progressive" if progressive else
                      ("baseline" if frame.precision == 8 else "extended")]
    out = b"\xff\xd8" + b"".join(app)
    for t, q in sorted(quant.items()):
        q = np.asarray(q, np.int64)
        if q.max() > 255:
            out += _marker(0xDB, bytes([0x10 | t]) + q[ZIGZAG].astype(">u2").tobytes())
        else:
            out += _marker(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8)))
    body = struct.pack(">BHHB", frame.precision, frame.height, frame.width, len(frame.comps))
    for comp in frame.comps:
        body += bytes([comp["id"], comp["h"] * 16 + comp["v"], comp.get("tq", 0)])
    out += _marker(sof, body)
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    if coding == "arith" and (dac["dc"] or dac["ac"]):
        seg = b""
        for c, (lo, hi) in sorted(dac["dc"].items()):
            seg += bytes([c, hi * 16 + lo])
        for c, k in sorted(dac["ac"].items()):
            seg += bytes([16 + c, k])
        out += _marker(0xCC, seg)
    for scan in scans:
        out += _scan(frame, scan, coding, progressive, restart, dac, psv, pt)
    return out + b"\xff\xd9"


def _scan(frame, scan, coding, progressive, restart, dac, psv, pt):
    comps = list(scan[0])
    if frame.lossless:
        ss, se, ah, al = psv, 0, 0, pt
    else:
        ss, se, ah, al = scan[1:]
    units = frame.units(comps)
    if frame.lossless:
        if len(comps) != 1:
            raise ValueError("the lossless encoder writes one component a scan")
        c = comps[0]
        w = frame.comp_size(c)[0]
        if restart and restart % w:
            raise ValueError("a lossless restart interval must be whole rows")
        diffs = lossless_differences(frame.comps[c]["samples"], frame.precision, psv, pt,
                                     restart // w if restart else 0)
    coder = (ArithScan(comps, ss, se, ah, al, progressive, dac) if coding == "arith"
             else HuffmanScan(comps, ss, se, ah, al, progressive))
    segments = []
    for m, mcu in enumerate(units):
        if restart and m and m % restart == 0:
            segments.append(coder.end_interval())
        for c, y, x in mcu:
            if frame.lossless:
                d = int(diffs[y, x])
                s = 16 if d == 32768 else abs(d).bit_length()
                bits = 0 if s in (0, 16) else (d if d >= 0 else d + (1 << s) - 1)
                coder.sym(("dc", c), s, bits, 0 if s == 16 else s)
            else:
                coder.block(c, frame.comps[c]["coef"][y, x])
    segments.append(coder.end_interval())
    header = b""
    if coding == "huffman":
        freq = {}
        for events in segments:
            for table, s, _, _ in events:
                if table is not None:
                    freq.setdefault(table, np.zeros(257, np.int64))[s] += 1
        tables = {t: optimal_table(f) for t, f in freq.items()}
        dht = b""
        for (kind, c), (counts, vals) in sorted(tables.items()):
            dht += bytes([(kind == "ac") * 16 + c]) + counts + vals
        if dht:
            header += _marker(0xC4, dht)
        codes = {t: _codes(*v) for t, v in tables.items()}
        data = []
        for events in segments:
            vals, lens = [], []
            for table, s, bits, n in events:
                if table is not None:
                    code, length = codes[table][s]
                    vals.append((code << n) | bits)
                    lens.append(length + n)
                else:
                    vals.append(bits)
                    lens.append(n)
            data.append(_segment(np.array(vals, np.int64), np.array(lens, np.int64)))
    else:
        data = segments
    sos = bytes([len(comps)]) + b"".join(bytes([frame.comps[c]["id"], c * 17]) for c in comps)
    sos += bytes([ss, se, ah * 16 + al])
    payload = data[0]
    for i, seg in enumerate(data[1:]):
        payload += bytes([0xFF, 0xD0 + i % 8]) + seg
    return header + _marker(0xDA, sos) + payload


def dct_coefficients(plane: np.ndarray, q, rows: int, cols: int, precision: int = 8):
    """Quantised DCT coefficients (rows, cols, 64) int64, natural order, of
    ``plane`` padded by edge replication to rows x cols blocks."""
    h, w = plane.shape
    padded = np.pad(plane.astype(np.float64), ((0, rows * 8 - h), (0, cols * 8 - w)),
                    mode="edge") - (1 << (precision - 1))
    blk = padded.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    f = _fdct_matrix()
    dct = f @ blk @ f.T
    lim = (1 << (precision + 2)) - 1
    q = np.asarray(q, np.float64).reshape(8, 8)
    return np.clip(np.rint(dct / q), -lim, lim).astype(np.int64).reshape(rows, cols, 64)


def jpeg_frame(planes, sampling, precision=8, quality=90, ids=None, tq=None):
    """A `Frame` and its quant tables for sample planes at full size
    (each subsampled here by block averaging to its (h, v))."""
    h, w = planes[0].shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    comps, quant = [], {}
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    for k, (plane, (ch, cv)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // ch, vmax // cv
        ph, pw = -(-h // fy) * fy, -(-w // fx) * fx
        p = np.pad(plane.astype(np.float64), ((0, ph - h), (0, pw - w)), mode="edge")
        p = p.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        if precision == 12:
            p = p * 16
        t = (tq[k] if tq else min(k, 1))
        if t not in quant:
            base = LUMA_Q if t == 0 else np.clip(LUMA_Q[::-1] + 10, 1, 255)
            quant[t] = quant_table(quality, base)
        comps.append(dict(id=(ids[k] if ids else k + 1), h=ch, v=cv, tq=t,
                          coef=dct_coefficients(p, quant[t], my * cv, mx * ch, precision)))
    return Frame(w, h, comps, precision), quant


def reconstruct(frame: Frame, quant: dict, comp: int = 0) -> np.ndarray:
    """The plane of component ``comp`` that a decoder rebuilds: the islow
    IDCT of its coefficients (lossless: its samples), cropped to the
    component's size."""
    c = frame.comps[comp]
    w, h = frame.comp_size(comp)
    if frame.lossless:
        return c["samples"][:h, :w]
    rows, cols = c["coef"].shape[:2]
    pix = idct_islow(c["coef"].reshape(-1, 8, 8), np.asarray(quant[c["tq"]]))
    pix = pix.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
    return np.ascontiguousarray(pix[:h, :w])


def full_progression(ncomp: int, refine: bool = True):
    """A progressive scan script: the DC of all components interleaved at
    Al = 1, spectral bands of each component at Al = 1 (or 0), then the
    refinement scans down to Al = 0."""
    al = 1 if refine else 0
    scans = [(tuple(range(ncomp)), 0, 0, 0, al)]
    for c in range(ncomp):
        scans += [((c,), 1, 5, 0, al + 1 if refine else 0), ((c,), 6, 63, 0, al)]
    if refine:
        for c in range(ncomp):
            scans += [((c,), 1, 5, al + 1, al)]
        scans += [(tuple(range(ncomp)), 0, 0, al, 0)]
        for c in range(ncomp):
            scans += [((c,), 1, 63, al, 0)]
    return scans


def lossless_frame(samples, precision):
    """A one-component lossless `Frame` of (H, W) samples."""
    h, w = samples.shape
    return Frame(w, h, [dict(id=1, h=1, v=1, tq=0, samples=np.asarray(samples, np.int64))],
                 precision, lossless=True)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

ADAM7 = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1)]                        # (row start, column start, row step, column step)


def _png_rows(px: np.ndarray, depth: int) -> np.ndarray:
    h, w, ch = px.shape
    if depth == 16:
        return px.astype(">u2").reshape(h, w * ch).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, w * ch)
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = px[:, :, 0]
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(padded.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for y in range(rows.shape[0]):
        kind = filters[y % len(filters)]
        out.append(bytes([kind]) + filter_row(kind, rows[y], prev, bpp).tobytes())
        prev = rows[y]
    return b"".join(out)


def encode_png_any(pixels, colour=0, depth=8, palette=None, interlace=False,
                   filters=(0, 1, 2, 3, 4), chunks=(), level=6) -> bytes:
    """PNG bytes of ``pixels`` ((H, W) or (H, W, channels): samples at
    ``depth``, palette indices for colour type 3) in any colour type and
    depth, Adam7-interlaced when ``interlace``; ``chunks``: (type, body)
    ancillary chunks written before the image data (tRNS after PLTE)."""
    px = np.asarray(pixels)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, ch = px.shape
    assert ch == CHANNELS[colour], (ch, colour)
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b""
        for y0, x0, dy, dx in ADAM7:
            sub = px[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                data += _filtered(_png_rows(sub, depth), bpp, filters)
    else:
        data = _filtered(_png_rows(px, depth), bpp, filters)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    chunks = list(chunks)
    for kind, body in chunks:
        if kind != b"tRNS":
            out += _chunk(kind, body)
    if colour == 3:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    for kind, body in chunks:
        if kind == b"tRNS":
            out += _chunk(kind, body)
    out += _chunk(b"IDAT", zlib.compress(data, level))
    return out + _chunk(b"IEND", b"")


# ---------------------------------------------------------------------------
# Files the reader checks on the card use (chip_smoke.py phase 18)
# ---------------------------------------------------------------------------

def _planes(seed: int, size):
    from torch_mura_tree import xray_like
    g = xray_like(np.random.default_rng(seed), *size)
    return g, [g, np.roll(g, 5, 1), 255 - g]


def corpus_file(name: str, size=(390, 320), seed: int = 18):
    """(file bytes, what a decoder must give) of one of `CORPUS`'s files at
    ``size``: the islow IDCT of the luma's final coefficients for the DCT
    formats, the written samples (after the point transform) for lossless
    JPEGs and PNGs."""
    g, col = _planes(seed, size)
    if name == "progressive-gray":
        fr, q = jpeg_frame([g], [(1, 1)])
        return write_jpeg(fr, q, full_progression(1), progressive=True), reconstruct(fr, q)
    if name == "progressive-420-rst":
        fr, q = jpeg_frame(col, [(2, 2), (1, 1), (1, 1)])
        return (write_jpeg(fr, q, full_progression(3), progressive=True, restart=7),
                reconstruct(fr, q))
    if name == "arith-sequential-dac":
        fr, q = jpeg_frame([g], [(1, 1)])
        dac = {"dc": {0: (2, 5)}, "ac": {0: 12}}
        return (write_jpeg(fr, q, [((0,), 0, 63, 0, 0)], coding="arith", restart=5, dac=dac),
                reconstruct(fr, q))
    if name == "arith-progressive-420":
        fr, q = jpeg_frame(col, [(2, 2), (1, 1), (1, 1)])
        return (write_jpeg(fr, q, full_progression(3), coding="arith", progressive=True),
                reconstruct(fr, q))
    if name == "lossless-8-p7":
        fr = lossless_frame(g.astype(np.int64), 8)
        return (write_jpeg(fr, {}, [((0,),)], psv=7, pt=1, restart=4 * size[1]),
                (g >> 1 << 1).astype(np.uint8))
    if name == "lossless-5-p4":
        s5 = (g >> 3).astype(np.int64)
        return (write_jpeg(lossless_frame(s5, 5), {}, [((0,),)], psv=4), s5.astype(np.uint8))
    if name == "png-adam7-gray8":
        return encode_png_any(g, 0, 8, interlace=True), g
    if name == "png-gray4":
        return encode_png_any(g >> 4, 0, 4), (g >> 4) * np.uint8(17)
    if name == "png-rgb16-adam7":
        s16 = g.astype(np.uint16) * 257 + 3
        return encode_png_any(np.stack([s16] * 3, 2), 2, 16, interlace=True), g
    raise ValueError(name)


CORPUS = ("progressive-gray", "progressive-420-rst", "arith-sequential-dac",
          "arith-progressive-420", "lossless-8-p7", "lossless-5-p4", "png-adam7-gray8",
          "png-gray4", "png-rgb16-adam7")


def damaged_file(name: str, size=(390, 320), seed: int = 18) -> bytes:
    """One of `DAMAGED`'s files: cut, corrupt, short of a full progression,
    or in a colour model whose gray cv2 computes (their gray images' digests
    are `DAMAGED_SHA256`)."""
    g, col = _planes(seed, size)
    cmyk = [g, np.roll(g, 3, 0), 255 - g, np.clip(g.astype(int) // 2 + 60, 0, 255)]
    fr, q = jpeg_frame([g], [(1, 1)])
    f3, q3 = jpeg_frame(col, [(2, 2), (1, 1), (1, 1)])

    def flip(raw, seed_, n):
        r = np.random.default_rng(seed_)
        b = bytearray(raw)
        start = raw.index(b"\xff\xda") + 10
        for pos in r.integers(start, len(raw) - 2, n):
            b[int(pos)] = int(r.integers(0, 256))
        return bytes(b)

    if name == "baseline-cut-60":
        raw = write_jpeg(fr, q, [((0,), 0, 63, 0, 0)])
        return raw[:len(raw) * 6 // 10]
    if name == "baseline-420-rst2-corrupt":
        return flip(write_jpeg(f3, q3, [((0, 1, 2), 0, 63, 0, 0)], restart=2), 1, 3)
    if name == "progressive-gray-cut-45":
        raw = write_jpeg(fr, q, full_progression(1), progressive=True)
        return raw[:len(raw) * 45 // 100]
    if name == "progressive-420-rst3-cut-80":
        raw = write_jpeg(f3, q3, full_progression(3), progressive=True, restart=3)
        return raw[:len(raw) * 8 // 10]
    if name == "progressive-gray-corrupt":
        return flip(write_jpeg(fr, q, full_progression(1), progressive=True), 2, 2)
    if name == "progressive-no-eoi":
        return write_jpeg(f3, q3, full_progression(3), progressive=True)[:-2]
    if name == "progressive-short-of-al0":
        return write_jpeg(f3, q3, full_progression(3)[:7], progressive=True)
    if name == "arith-progressive-cut-70":
        raw = write_jpeg(fr, q, full_progression(1), coding="arith", progressive=True, restart=4)
        return raw[:len(raw) * 7 // 10]
    if name == "cmyk-adobe":
        f4, q4 = jpeg_frame(cmyk, [(1, 1)] * 4)
        return write_jpeg(f4, q4, [((0, 1, 2, 3), 0, 63, 0, 0)], app=(adobe(0),))
    if name == "ycck-adobe-420":
        f4, q4 = jpeg_frame(cmyk, [(2, 2), (1, 1), (1, 1), (2, 2)])
        return write_jpeg(f4, q4, full_progression(4), progressive=True, app=(adobe(2),))
    if name == "rgb-adobe":
        fr3, qr = jpeg_frame(col, [(1, 1), (1, 1), (1, 1)])
        return write_jpeg(fr3, qr, [((0, 1, 2), 0, 63, 0, 0)], app=(adobe(0),))
    if name == "luma-below-chroma":
        fl, ql = jpeg_frame(col, [(1, 1), (2, 2), (1, 1)])
        return write_jpeg(fl, ql, [((0, 1, 2), 0, 63, 0, 0)])
    raise ValueError(name)


DAMAGED = ("baseline-cut-60", "baseline-420-rst2-corrupt", "progressive-gray-cut-45",
           "progressive-420-rst3-cut-80", "progressive-gray-corrupt", "progressive-no-eoi",
           "progressive-short-of-al0", "arith-progressive-cut-70", "cmyk-adobe",
           "ycck-adobe-420", "rgb-adobe", "luma-below-chroma")
# sha256 of cv2.imread(path, IMREAD_GRAYSCALE).tobytes() for `damaged_file`'s
# files at 390 x 320 (tests/test_torch_jpeg_formats.py pins them to cv2)
DAMAGED_SHA256 = {
    "baseline-cut-60": "cb8a92d59bd684616dcf85a8e25aa9af860bbc9b996f61385079aa2a8d0606aa",
    "baseline-420-rst2-corrupt": "0c6f8c8314b219ea2f8dbf618e8ee6f452c121da6a973007bd65c9411c5d4dbf",
    "progressive-gray-cut-45": "e6469263e3e526e51d251575b5e5281e1d403c0c8102262f77771bb2d0dcd761",
    "progressive-420-rst3-cut-80": "3cbf06feac81daf996ee9fa697b6c5b9964889522de6f89e64cc800ac1a99398",
    "progressive-gray-corrupt": "ee525298d1bec3411cb897a681044e80308d1a1d76a859f87639924ef38af5f1",
    "progressive-no-eoi": "cbe79eca14528a87c286e8357ed76a24452552674c42e867f386fc5fb0dd618b",
    "progressive-short-of-al0": "ffe01e1a72de7a77fa16d39efbc552bab13a0e1dfcef8c658185971f888b2b57",
    "arith-progressive-cut-70": "3cc0eb10ab4ef3ebbd6b87fdb55916d577d0fe037a6612dd69a5e303043e15f2",
    "cmyk-adobe": "9916175c5ff00d257913629490b83a39e456b630a34ff80ed5327f3fbd5f81cb",
    "ycck-adobe-420": "6ee22eeea4bdd00334c61e892791a51850165138eda140b41216721ccadfc992",
    "rgb-adobe": "433e1af6b55c13567df61407a8d497f532426502c58685b8cc0a8aeb7880db08",
    "luma-below-chroma": "c1844c99ed11daf9c6ec57a3be82b9959d9a70ce363996d3de4c285c99a9abe3",
}


def gray_digest(img: np.ndarray) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()


def reencode_jpeg(gray: np.ndarray, kind: str) -> bytes:
    """The (H, W) uint8 image ``gray`` as a JPEG of ``kind``: progressive,
    arith (sequential), arith-progressive, truncated (a baseline file cut at
    90 %) or cmyk (four components, Adobe transform 0)."""
    fr, q = jpeg_frame([gray], [(1, 1)])
    if kind == "progressive":
        return write_jpeg(fr, q, full_progression(1), progressive=True)
    if kind == "arith":
        return write_jpeg(fr, q, [((0,), 0, 63, 0, 0)], coding="arith")
    if kind == "arith-progressive":
        return write_jpeg(fr, q, full_progression(1), coding="arith", progressive=True)
    if kind == "truncated":
        raw = write_jpeg(fr, q, [((0,), 0, 63, 0, 0)])
        return raw[:len(raw) * 9 // 10]
    if kind == "cmyk":
        planes = [255 - gray, 255 - gray, 255 - gray, np.full_like(gray, 255)]
        f4, q4 = jpeg_frame(planes, [(1, 1)] * 4)
        return write_jpeg(f4, q4, [((0, 1, 2, 3), 0, 63, 0, 0)], app=(adobe(0),))
    raise ValueError(kind)


def reencode_png(gray: np.ndarray, kind: str) -> bytes:
    """The (H, W) uint8 image ``gray`` as a PNG of ``kind``: adam7 (gray,
    interlaced), gray2 / gray4 (its top bits), rgb16 (16-bit colour,
    interlaced) or palette4 (16 gray levels through a palette)."""
    if kind == "adam7":
        return encode_png_any(gray, 0, 8, interlace=True)
    if kind in ("gray2", "gray4"):
        d = int(kind[-1])
        return encode_png_any(gray >> (8 - d), 0, d)
    if kind == "rgb16":
        s16 = gray.astype(np.uint16) * 257
        return encode_png_any(np.stack([s16, s16 // 2 + 1000, s16], 2), 2, 16, interlace=True)
    if kind == "palette4":
        pal = np.repeat(np.arange(16, dtype=np.uint8)[:, None] * 17, 3, 1)
        return encode_png_any(gray >> 4, 3, 4, palette=pal)
    raise ValueError(kind)


def corpus_job(name: str, size, seed: int, out: str) -> str:
    """Write `corpus_file`'s file as ``out`` and its expected gray image as
    ``out + ".npy"`` (for chip_smoke.py's worker processes)."""
    raw, want = corpus_file(name, size, seed)
    with open(out, "wb") as f:
        f.write(raw)
    np.save(out + ".npy", want)
    return out


# ---- TIFF -------------------------------------------------------------------

TIFF_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 8), 11: ("f", 4),
              12: ("d", 8), 16: ("Q", 8)}


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, 9-12 bits, the width growing one code
    early, Clear first and whenever the table fills, EOI last)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits, free, table = 9, 258, {}

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    emit(256)
    w = None
    for b in data:
        if w is None:
            w = b
            continue
        k = (w, b)
        if k in table:
            w = table[k]
            continue
        emit(w)
        table[k] = free
        free += 1
        if free >= 4094:
            emit(256)
            nbits, free, table = 9, 258, {}
        elif free > (1 << nbits) - 1:
            nbits += 1
        w = b
    if w is not None:
        emit(w)
        free += 1
        if free > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()

    def flush():
        while lit:
            part = lit[:128]
            out.append(len(part) - 1)
            out.extend(part)
            del lit[:128]
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            flush()
            out.append((257 - (j - i)) & 255)
            out.append(data[i])
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _pack_rows(samples: np.ndarray, bits: int, order: str, kind: str) -> np.ndarray:
    """(rows, width, spp) samples -> (rows, row bytes) uint8."""
    h, w, s = samples.shape
    if bits >= 8:
        if bits == 12:
            raise ValueError("12-bit samples: use _pack12")
        dt = np.dtype(f"{order}{kind}{bits // 8}")
        return np.ascontiguousarray(samples.astype(dt)).view(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, w * s).astype(np.uint8)
    bitsarr = ((flat[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bitsarr.astype(np.uint8), axis=1)


def _pack12(samples: np.ndarray) -> np.ndarray:
    h, w, s = samples.shape
    v = samples.reshape(h, w * s).astype(np.uint16)
    bitsarr = ((v[:, :, None] >> np.arange(11, -1, -1)) & 1).reshape(h, -1).astype(np.uint8)
    return np.packbits(bitsarr, axis=1)


def _predict(rows: np.ndarray, predictor: int, bits: int, spp: int, order: str, kind: str):
    """Horizontal (2) or floating-point (3) differencing of packed rows."""
    if predictor == 1:
        return rows
    h = rows.shape[0]
    k = bits // 8
    if predictor == 2:
        dt = np.dtype(f"{order}{'u' if kind != 'f' else 'u'}{k}")
        v = rows.copy().view(dt).reshape(h, -1, spp).astype(np.uint64)
        d = v.copy()
        d[:, 1:] = (v[:, 1:] - v[:, :-1]) & np.uint64((1 << bits) - 1)
        return np.ascontiguousarray(d.astype(dt)).view(np.uint8).reshape(h, -1)
    # floating point: host little-endian values -> big-endian byte planes,
    # then byte differencing a pixel's samples apart
    n = rows.shape[1] // k
    vals = rows.copy().view(np.dtype(f"{order}u{k}")).astype(np.dtype(f">u{k}"))
    planes = vals.view(np.uint8).reshape(h, n, k).transpose(0, 2, 1).reshape(h, -1)
    d = planes.astype(np.int64)
    d[:, spp:] = (planes[:, spp:].astype(np.int64) - planes[:, :-spp]) & 255
    return d.astype(np.uint8)


def write_tiff(samples, *, bits=8, kind="u", photometric=1, compression=1, predictor=1,
               order="<", bigtiff=False, rows_per_strip=None, tile=None, planar=1,
               fill_order=1, extra_samples=None, colormap=None, orientation=None,
               tags=None, ifd_first=True, pages=1, codec=None) -> bytes:
    """A TIFF of the (H, W) or (H, W, samples) array ``samples``: ``bits``
    per sample (1-64; ``kind`` "u", "i" or "f"), strips of
    ``rows_per_strip`` rows or ``tile`` = (height, width) tiles, contiguous
    or planar, compression 1 (none), 5 (LZW), 8 / 32946 (Deflate) or 32773
    (PackBits) with predictor 1-3, either byte order, classic or BigTIFF,
    FillOrder 2 (the compressed bytes' bits reversed), the directory before
    or after the data, ``pages`` copies of the image (each its own
    directory).  ``codec`` replaces the compressor (bytes -> bytes);
    ``tags`` adds or overrides entries {tag: (type, values)}."""
    px = np.asarray(samples)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, spp = px.shape
    planes = [px] if planar == 1 else [px[:, :, i:i + 1] for i in range(spp)]
    s_pp = spp if planar == 1 else 1

    def encode(block):
        rows = _pack12(block) if bits == 12 else _pack_rows(block, bits, order, kind)
        rows = _predict(rows, predictor, bits, s_pp, order, kind)
        data = rows.tobytes()
        if codec is not None:
            data = codec(data)
        elif compression == 5:
            data = lzw_encode(data)
        elif compression in (8, 32946):
            data = zlib.compress(data)
        elif compression == 32773:
            data = b"".join(packbits_encode(r.tobytes()) for r in rows)
        if fill_order == 2:
            data = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
            data = np.packbits(data).tobytes()
        return data

    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(encode(p[y:y + rps]))
    else:
        th, tw = tile
        for p in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), p.dtype)
                    part = p[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(t))
    sf = {"u": 1, "i": 2, "f": 3}[kind]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar]),
               339: (3, [sf] * spp)}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if extra_samples is not None:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if orientation is not None:
        entries[274] = (3, [orientation])
    off_type = 16 if bigtiff else 4
    if tile is None:
        entries[278] = (4, [rows_per_strip or h])
        entries[279] = (off_type, [len(c) for c in chunks])
        where, counts = 273, 279
    else:
        entries[322] = (4, [tile[1]])
        entries[323] = (4, [tile[0]])
        entries[325] = (off_type, [len(c) for c in chunks])
        where, counts = 324, 325
    entries.update(tags or {})
    entries[where] = (off_type, [0] * len(chunks))
    head_size = 16 if bigtiff else 8
    ent_size, count_fmt, off_fmt = (20, "Q", "Q") if bigtiff else (12, "H", "I")
    inline = 8 if bigtiff else 4

    def ifd_bytes(base, data_offsets, next_ifd):
        entries[where] = (entries[where][0], data_offsets)
        n = len(entries)
        size = (8 if bigtiff else 2) + n * ent_size + (8 if bigtiff else 4)
        extra = b""
        body = b""
        for tag in sorted(entries):
            typ, vals = entries[tag]
            fmt, unit = TIFF_TYPES[typ]
            if typ == 5:
                payload = b"".join(struct.pack(order + "II", *v) for v in vals)
            elif typ == 2:
                payload = bytes(vals)
            else:
                payload = struct.pack(order + fmt * len(vals), *vals)
            count = len(vals)
            if len(payload) <= inline:
                val = payload + b"\0" * (inline - len(payload))
            else:
                val = struct.pack(order + off_fmt, base + size + len(extra))
                extra += payload + b"\0" * (len(payload) % 2)
            body += struct.pack(order + ("HHQ" if bigtiff else "HHI"), tag, typ, count) + val
        return (struct.pack(order + count_fmt, n) + body + struct.pack(order + off_fmt, next_ifd)
                + extra)

    mark = b"II" if order == "<" else b"MM"
    out = bytearray(head_size)
    first = None
    for page in range(pages):
        # lay out the directory (its size does not depend on the offsets)
        probe = ifd_bytes(0, [0] * len(chunks), 0)
        if ifd_first:
            ifd_at = len(out)
            data_at = ifd_at + len(probe) + len(probe) % 2
        else:
            data_at = len(out)
        offsets, pos = [], data_at
        for c in chunks:
            offsets.append(pos)
            pos += len(c) + len(c) % 2
        if not ifd_first:
            ifd_at = pos
        nxt = 0
        if page + 1 < pages:
            nxt = (max(ifd_at + len(probe) + len(probe) % 2, pos) if ifd_first
                   else ifd_at + len(probe) + len(probe) % 2)
        ifd = ifd_bytes(ifd_at, offsets, nxt)
        data = b"".join(c + b"\0" * (len(c) % 2) for c in chunks)
        if ifd_first:
            out += ifd + b"\0" * (len(ifd) % 2) + data
        else:
            out += data + ifd + b"\0" * (len(ifd) % 2)
        if first is None:
            first = ifd_at
    if bigtiff:
        out[:16] = mark + struct.pack(order + "HHHQ", 43, 8, 0, first)
    else:
        out[:8] = mark + struct.pack(order + "HI", 42, first)
    return bytes(out)


# ---- BMP --------------------------------------------------------------------

def bmp_rows(values: np.ndarray, bits: int) -> bytes:
    """(H, W) indices or 16-bit words, or (H, W, 3 | 4) B, G, R(, A)
    bytes, as bottom-up... no: as the rows given, each padded to 4 bytes."""
    v = np.asarray(values)
    h = v.shape[0]
    if bits < 8:
        flat = v.reshape(h, -1).astype(np.uint8)
        bitsarr = ((flat[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(h, -1)
        rows = np.packbits(bitsarr.astype(np.uint8), axis=1)
    elif bits == 16:
        rows = np.ascontiguousarray(v.astype("<u2")).view(np.uint8).reshape(h, -1)
    else:
        rows = v.reshape(h, -1).astype(np.uint8)
    pad = -rows.shape[1] % 4
    return np.concatenate([rows, np.zeros((h, pad), np.uint8)], axis=1).tobytes()


def rle_bmp(indices: np.ndarray, rle4: bool, rng=None, eob=True, deltas=False) -> bytes:
    """RLE8 / RLE4 data for the (H, W) index rows given in file order:
    runs of equal indices as encoded runs (pairs of indices for RLE4),
    the rest as absolute runs (3 or more) or short runs; end of line after
    each row, end of bitmap at the end.  With ``rng``, run lengths and
    absolute lengths vary; with ``deltas``, runs of index 0 may become
    deltas (which a reader fills with entry 0)."""
    out = bytearray()
    h, w = indices.shape
    for y in range(h):
        row = [int(v) for v in indices[y]]
        x = 0
        while x < w:
            if deltas and row[x] == 0 and rng is not None and rng.random() < .5:
                n = 1
                while x + n < w and row[x + n] == 0 and n < 255:
                    n += 1
                out += bytes([0, 2, n, 0])
                x += n
                continue
            n = 1
            limit = 255 if rng is None else int(rng.integers(1, 256))
            if rle4:
                while x + n < w and n < limit and row[x + n] == row[x + (n % 2)]:
                    n += 1
                if n >= 2 or x + 1 >= w or rng is None or rng.random() < .5:
                    hi, lo = row[x], row[x + 1] if x + 1 < w and n > 1 else row[x]
                    out += bytes([n, (hi << 4) | lo])
                    x += n
                    continue
            else:
                while x + n < w and n < limit and row[x + n] == row[x]:
                    n += 1
                if n >= 3 or w - x < 3 or (rng is not None and rng.random() < .5):
                    out += bytes([n, row[x]])
                    x += n
                    continue
            k = min(w - x, 255 if rng is None else int(rng.integers(3, 256)))
            if k < 3:
                out += bytes([1, (row[x] << 4) | row[x] if rle4 else row[x]])
                x += 1
                continue
            seg = row[x:x + k]
            if rle4:
                packed = bytes(((seg[i] << 4) | (seg[i + 1] if i + 1 < k else 0))
                               for i in range(0, k, 2))
                packed += b"\0" * (len(packed) % 2)
            else:
                packed = bytes(seg) + b"\0" * (k % 2)
            out += bytes([0, k]) + packed
            x += k
        if y + 1 < h or not eob:
            out += b"\0\0"
    if eob:
        out += b"\0\1"
    return bytes(out)


def write_bmp(data: bytes, width: int, height: int, bits: int, compression: int = 0,
              header: int = 40, palette=None, masks=None, top_down: bool = False,
              colors_used: int = 0, offset=None) -> bytes:
    """A BMP around pixel ``data`` (rows as stored, bottom row first unless
    ``top_down``): ``header`` 12 (OS/2 core, 3-byte palette entries) or
    40-124 bytes, ``masks`` (R, G, B[, A]) after a 40-byte header or inside
    a longer one, ``palette`` (n, 3) R, G, B."""
    pal = b""
    if palette is not None:
        entry = 3 if header == 12 else 4
        pal = b"".join(bytes([int(b), int(g), int(r)]) + b"\0" * (entry - 3)
                       for r, g, b in np.asarray(palette))
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(data), 2835, 2835, colors_used, 0)
        if header >= 52 and masks is not None:
            info += struct.pack("<III", *masks[:3])
            if header >= 56:
                info += struct.pack("<I", masks[3] if len(masks) > 3 else 0)
        info += b"\0" * (header - len(info))
    after = struct.pack("<III", *masks[:3]) if header == 40 and masks is not None else b""
    body = info + after + pal
    off = 14 + len(body) if offset is None else offset
    head = b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off)
    return (head + body).ljust(off, b"\0")[:off] + data


# ---- Netpbm -----------------------------------------------------------------

def write_pnm(samples, kind: int, maxval: int = 255, comments=(), sep: bytes = b" ",
              line: int = 0) -> bytes:
    """P1-P6 of (H, W) or (H, W, 3) samples: the header's numbers with
    ``comments`` between them, ASCII samples joined by ``sep`` (a newline
    every ``line`` samples when given), raw samples as bytes or big-endian
    16-bit words past maxval 255, PBM rows packed."""
    v = np.asarray(samples)
    h, w = v.shape[:2]
    head = [f"P{kind}".encode(), str(w).encode(), str(h).encode()]
    if kind not in (1, 4):
        head.append(str(maxval).encode())
    out = bytearray(head[0])
    for k, tok in enumerate(head[1:]):
        out += b"\n"
        if k < len(comments) and comments[k]:
            out += b"#" + comments[k].encode() + b"\n"
        out += tok
    out += b"\n"
    if kind in (1, 2, 3):
        toks = [str(int(x)).encode() for x in v.reshape(-1)]
        if line:
            out += b"\n".join(sep.join(toks[i:i + line]) for i in range(0, len(toks), line))
        else:
            out += sep.join(toks)
        out += b"\n"
    elif kind == 4:
        out += np.packbits(v.astype(np.uint8), axis=1).tobytes()
    else:
        out += v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return bytes(out)


def write_pam(samples, maxval: int, tupltype=None, comment: bool = False) -> bytes:
    """P7 of (H, W, depth) samples."""
    v = np.asarray(samples)
    h, w, d = v.shape
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\n" + ("# a comment\n" if comment else "")
    head += f"DEPTH {d}\nMAXVAL {maxval}\n" + (f"TUPLTYPE {tupltype}\n" if tupltype else "")
    return (head + "ENDHDR\n").encode() + v.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def write_pfm(values, scale: float = -1.0, colour: bool = False) -> bytes:
    """Pf / PF of (H, W[, 3]) floats, rows bottom to top, little-endian for
    a negative scale."""
    v = np.asarray(values, np.float32)
    h, w = v.shape[:2]
    head = f"{'PF' if colour else 'Pf'}\n{w} {h}\n{scale!r}\n".encode()
    return head + v[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


# ---- Sun raster ---------------------------------------------------------------

def sunras_rle(data: bytes, runs: bool = True) -> bytes:
    """Byte-encoded (type 2) data: runs of 3 or more (up to 256) as 0x80
    n v, a literal 0x80 as 0x80 0."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        if runs and j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        else:
            out += b"\x80\x00" if data[i] == 0x80 else bytes([data[i]])
            i += 1
    return bytes(out)


def write_sunras(data: bytes, width: int, height: int, depth: int, kind: int = 1,
                 colormap=None) -> bytes:
    """A Sun raster around ``data`` (rows as stored): ``kind`` 0 old, 1
    standard, 2 byte-encoded, 3 RGB; ``colormap`` (3, n) R, G, B planes."""
    cmap = b"" if colormap is None else np.asarray(colormap, np.uint8).tobytes()
    head = struct.pack(">8I", 0x59A66A95, width, height, depth, len(data), kind,
                       1 if cmap else 0, len(cmap))
    return head + cmap + data


def sunras_rows(values: np.ndarray, depth: int, pad: bool = True) -> bytes:
    """(H, W) indices or (H, W, 3 | 4) bytes as rows, padded to 16 bits
    unless ``pad`` is false."""
    v = np.asarray(values)
    h = v.shape[0]
    if depth < 8:
        flat = v.reshape(h, -1).astype(np.uint8)
        bits = ((flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
        rows = np.packbits(bits.astype(np.uint8), axis=1)
    else:
        rows = v.reshape(h, -1).astype(np.uint8)
    if pad and rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], axis=1)
    return rows.tobytes()


# ---- CCITT --------------------------------------------------------------------

# T.4's run codes: {run: bits} for white and black terminating and make-up
# codes, and the extended make-up codes both colours share
FAX_TERM_WHITE = {
    0: "00110101", 1: "000111", 2: "0111", 3: "1000", 4: "1011", 5: "1100", 6: "1110",
    7: "1111", 8: "10011", 9: "10100", 10: "00111", 11: "01000", 12: "001000", 13: "000011",
    14: "110100", 15: "110101", 16: "101010", 17: "101011", 18: "0100111", 19: "0001100",
    20: "0001000", 21: "0010111", 22: "0000011", 23: "0000100", 24: "0101000", 25: "0101011",
    26: "0010011", 27: "0100100", 28: "0011000", 29: "00000010", 30: "00000011",
    31: "00011010", 32: "00011011", 33: "00010010", 34: "00010011", 35: "00010100",
    36: "00010101", 37: "00010110", 38: "00010111", 39: "00101000", 40: "00101001",
    41: "00101010", 42: "00101011", 43: "00101100", 44: "00101101", 45: "00000100",
    46: "00000101", 47: "00001010", 48: "00001011", 49: "01010010", 50: "01010011",
    51: "01010100", 52: "01010101", 53: "00100100", 54: "00100101", 55: "01011000",
    56: "01011001", 57: "01011010", 58: "01011011", 59: "01001010", 60: "01001011",
    61: "00110010", 62: "00110011", 63: "00110100"}
FAX_MAKEUP_WHITE = {
    64: "11011", 128: "10010", 192: "010111", 256: "0110111", 320: "00110110", 384: "00110111",
    448: "01100100", 512: "01100101", 576: "01101000", 640: "01100111", 704: "011001100",
    768: "011001101", 832: "011010010", 896: "011010011", 960: "011010100", 1024: "011010101",
    1088: "011010110", 1152: "011010111", 1216: "011011000", 1280: "011011001",
    1344: "011011010", 1408: "011011011", 1472: "010011000", 1536: "010011001",
    1600: "010011010", 1664: "011000", 1728: "010011011"}
FAX_TERM_BLACK = {
    0: "0000110111", 1: "010", 2: "11", 3: "10", 4: "011", 5: "0011", 6: "0010", 7: "00011",
    8: "000101", 9: "000100", 10: "0000100", 11: "0000101", 12: "0000111", 13: "00000100",
    14: "00000111", 15: "000011000", 16: "0000010111", 17: "0000011000", 18: "0000001000",
    19: "00001100111", 20: "00001101000", 21: "00001101100", 22: "00000110111",
    23: "00000101000", 24: "00000010111", 25: "00000011000", 26: "000011001010",
    27: "000011001011", 28: "000011001100", 29: "000011001101", 30: "000001101000",
    31: "000001101001", 32: "000001101010", 33: "000001101011", 34: "000011010010",
    35: "000011010011", 36: "000011010100", 37: "000011010101", 38: "000011010110",
    39: "000011010111", 40: "000001101100", 41: "000001101101", 42: "000011011010",
    43: "000011011011", 44: "000001010100", 45: "000001010101", 46: "000001010110",
    47: "000001010111", 48: "000001100100", 49: "000001100101", 50: "000001010010",
    51: "000001010011", 52: "000000100100", 53: "000000110111", 54: "000000111000",
    55: "000000100111", 56: "000000101000", 57: "000001011000", 58: "000001011001",
    59: "000000101011", 60: "000000101100", 61: "000001011010", 62: "000001100110",
    63: "000001100111"}
FAX_MAKEUP_BLACK = {
    64: "0000001111", 128: "000011001000", 192: "000011001001", 256: "000001011011",
    320: "000000110011", 384: "000000110100", 448: "000000110101", 512: "0000001101100",
    576: "0000001101101", 640: "0000001001010", 704: "0000001001011", 768: "0000001001100",
    832: "0000001001101", 896: "0000001110010", 960: "0000001110011", 1024: "0000001110100",
    1088: "0000001110101", 1152: "0000001110110", 1216: "0000001110111", 1280: "0000001010010",
    1344: "0000001010011", 1408: "0000001010100", 1472: "0000001010101", 1536: "0000001011010",
    1600: "0000001011011", 1664: "0000001100100", 1728: "0000001100101"}
FAX_MAKEUP = {
    1792: "00000001000", 1856: "00000001100", 1920: "00000001101", 1984: "000000010010",
    2048: "000000010011", 2112: "000000010100", 2176: "000000010101", 2240: "000000010110",
    2304: "000000010111", 2368: "000000011100", 2432: "000000011101", 2496: "000000011110",
    2560: "000000011111"}


def _fax_run(run: int, black: bool) -> str:
    """A run's code: make-up codes of 2560 while longer, one make-up code,
    then the terminating code."""
    term = FAX_TERM_BLACK if black else FAX_TERM_WHITE
    makeup = {**(FAX_MAKEUP_BLACK if black else FAX_MAKEUP_WHITE), **FAX_MAKEUP}
    out = ""
    while run >= 2624:
        out += FAX_MAKEUP[2560]
        run -= 2560
    if run >= 64:
        out += makeup[run // 64 * 64]
        run %= 64
    return out + term[run]


def _row_runs(row) -> list:
    """Alternating white / black run lengths of a row of 0 (white) and 1
    (black) pixels, starting with white."""
    runs, colour, n = [], 0, 0
    for v in row:
        if int(v) == colour:
            n += 1
        else:
            runs.append(n)
            colour, n = 1 - colour, 1
    runs.append(n)
    return runs


def fax_encode(pixels: np.ndarray, codec: int, two_d: bool = False) -> bytes:
    """CCITT data of (H, W) bits (1 black): codec 2 (modified Huffman, rows
    byte-aligned), 3 (Group 3, EOL before each row, ``two_d``: a 1D / 2D tag
    bit and every row in 2D horizontal mode) or 4 (Group 4, horizontal mode
    throughout, EOFB at the end)."""
    bits = ""
    for row in np.asarray(pixels):
        runs = _row_runs(row)
        if codec == 3:
            bits += "000000000001" + ("0" if two_d else "")
        if codec == 4 or (codec == 3 and two_d):
            if len(runs) % 2:
                runs.append(0)
            for k in range(0, len(runs), 2):
                bits += "001" + _fax_run(runs[k], False) + _fax_run(runs[k + 1], True)
        else:
            bits += "".join(_fax_run(r, bool(k % 2)) for k, r in enumerate(runs))
        if codec == 2:
            bits += "0" * (-len(bits) % 8)
    if codec == 4:
        bits += "000000000001" * 2
    elif codec == 3:
        bits += "000000000001" * 6
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[k:k + 8], 2) for k in range(0, len(bits), 8))


# ---- Files the raster readers check on the card (chip_smoke.py phase 19) -------

def _jpeg_strips(planes, sampling, rows: int) -> list:
    """One JPEG datastream a strip of ``rows`` rows of the planes."""
    out = []
    for y in range(0, planes[0].shape[0], rows):
        fr, q = jpeg_frame([p[y:y + rows] for p in planes], sampling)
        comps = tuple(range(len(planes)))
        out.append(write_jpeg(fr, q, [(comps, 0, 63, 0, 0)]))
    return out


def raster_file(name: str, size=(390, 320), seed: int = 25) -> bytes:
    """One of `RASTER`'s files (TIFF, BMP, Netpbm, Sun raster) of an x-ray
    like image ``size`` = (height, width); their gray images' digests are
    `RASTER_SHA256` at 390 x 320."""
    from torch_mura_tree import xray_like
    h, w = size
    rng = np.random.default_rng(seed)
    g = xray_like(rng, h, w)
    g16 = g.astype(np.uint16) * 257 + rng.integers(0, 256, g.shape).astype(np.uint16)
    rgb = np.stack([g, np.roll(g, 7, 1), 255 - g], axis=2)
    bits = (g > 120).astype(np.uint8)
    pal = np.stack([np.arange(16) * 17, 255 - np.arange(16) * 9, np.arange(16) * 5], 1)
    if name == "tiff-lzw-pred2-gray16-be":
        return write_tiff(g16, bits=16, compression=5, predictor=2, order=">", rows_per_strip=8)
    if name == "tiff-deflate-tiles-rgb8":
        return write_tiff(rgb, photometric=2, compression=8, predictor=2, tile=(64, 64))
    if name == "tiff-packbits-planar-rgb16":
        return write_tiff(rgb.astype(np.uint16) * 257, bits=16, photometric=2, planar=2,
                          compression=32773, rows_per_strip=32)
    if name == "tiff-raw-miniswhite-bigtiff":
        return write_tiff(g, photometric=0, bigtiff=True, rows_per_strip=17)
    if name == "tiff-lzw-palette4":
        return write_tiff(g >> 4, bits=4, photometric=3, compression=5,
                          colormap=pal.astype(np.int64) * 257)
    if name == "tiff-cmyk-lzw":
        cmyk = np.stack([255 - g, g // 2, np.roll(g, 3, 0), g // 4], axis=2)
        return write_tiff(cmyk, photometric=5, compression=5, rows_per_strip=40)
    if name == "tiff-g4-fillorder2":
        it = iter([fax_encode(bits[y:y + 64], 4) for y in range(0, h, 64)])
        return write_tiff(bits, bits=1, photometric=0, compression=4, fill_order=2,
                          rows_per_strip=64, codec=lambda d: next(it))
    if name == "tiff-g3-2d":
        it = iter([fax_encode(bits, 3, two_d=True)])
        return write_tiff(bits, bits=1, photometric=0, compression=3, tags={292: (4, [1])},
                          codec=lambda d: next(it))
    if name == "tiff-ccitt-rle":
        it = iter([fax_encode(bits[y:y + 50], 2) for y in range(0, h, 50)])
        return write_tiff(bits, bits=1, photometric=0, compression=2, rows_per_strip=50,
                          codec=lambda d: next(it))
    if name == "tiff-jpeg-ycbcr420":
        ycc = [g, np.roll(g, 5, 1), 255 - g]
        it = iter(_jpeg_strips(ycc, [(2, 2), (1, 1), (1, 1)], 64))
        return write_tiff(np.stack(ycc, 2), photometric=6, compression=7, rows_per_strip=64,
                          tags={530: (3, [2, 2])}, codec=lambda d: next(it))
    if name == "tiff-jpeg-gray":
        it = iter(_jpeg_strips([g], [(1, 1)], 48))
        return write_tiff(g, compression=7, rows_per_strip=48, codec=lambda d: next(it))
    if name == "tiff-float32-pred3":
        return write_tiff(g.astype(np.float32) * 1.25 - 20, bits=32, kind="f", compression=8,
                          predictor=3, rows_per_strip=32)
    if name == "tiff-int32":
        return write_tiff(g.astype(np.int64) - 40, bits=32, kind="i", rows_per_strip=64)
    if name == "tiff-orient3-tiles":
        return write_tiff(g, compression=5, tile=(48, 80), orientation=3)
    if name == "tiff-lzw-corrupt":
        raw = bytearray(write_tiff(g, compression=5, predictor=2, rows_per_strip=24))
        r = np.random.default_rng(seed + 1)
        for pos in r.integers(len(raw) // 3, len(raw) - 64, 3):
            raw[int(pos)] = int(r.integers(0, 256))
        return bytes(raw)
    if name == "bmp-8-rle8":
        idx = g >> 2
        return write_bmp(rle_bmp(idx[::-1], False), w, h, 8, 1,
                         palette=np.stack([np.arange(256)] * 3, 1)[::4][:64], colors_used=64)
    if name == "bmp-4-rle4-delta":
        idx = g >> 4
        idx[idx < 3] = 0
        return write_bmp(rle_bmp(idx[::-1], True, rng=np.random.default_rng(seed), deltas=True),
                         w, h, 4, 2, palette=pal)
    if name == "bmp-24-topdown":
        return write_bmp(bmp_rows(rgb[..., ::-1], 24), w, h, 24, top_down=True)
    if name == "bmp-16-565":
        v = ((g.astype(np.uint16) >> 3) << 11) | ((np.roll(g, 3, 1).astype(np.uint16) >> 2) << 5) \
            | (g.astype(np.uint16) >> 3)
        return write_bmp(bmp_rows(v[::-1], 16), w, h, 16, 3, masks=(0xF800, 0x7E0, 0x1F))
    if name == "bmp-32-v5-bitfields":
        bgra = np.concatenate([rgb[..., ::-1], g[..., None]], axis=2)
        return write_bmp(bmp_rows(bgra[::-1], 32), w, h, 32, 3, header=124,
                         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    if name == "bmp-1-os2":
        return write_bmp(bmp_rows(bits[::-1], 1), w, h, 1, header=12,
                         palette=np.array([[10, 20, 30], [240, 230, 220]]))
    if name == "bmp-8-rle8-no-eob":
        return write_bmp(rle_bmp((g >> 4)[::-1], False, eob=False), w, h, 8, 1, palette=pal,
                         colors_used=16)
    if name == "pgm-p5-maxval50":
        return write_pnm((g.astype(np.int64) * 50 // 255), 5, maxval=50)
    if name == "pgm-p5-16":
        return write_pnm(g16, 5, maxval=65535)
    if name == "pgm-p2-ascii":
        return write_pnm(g.astype(np.int64) * 1000 // 255, 2, maxval=1000, comments=["x-ray"])
    if name == "ppm-p6":
        return write_pnm(rgb, 6)
    if name == "ppm-p3-200":
        return write_pnm(rgb.astype(np.int64) * 200 // 255, 3, maxval=200, line=17)
    if name == "pbm-p4":
        return write_pnm(bits, 4)
    if name == "pbm-p1":
        return write_pnm(bits, 1, sep=b"", line=70)
    if name == "pam-gray":
        return write_pam(g[..., None], 255, "GRAYSCALE", comment=True)
    if name == "pam-rgb16":
        return write_pam(rgb.astype(np.int64) * 257, 65535, "RGB")
    if name == "pfm-gray":
        return write_pfm(g.astype(np.float32) / 255, scale=-1.0 / 255)
    if name == "sun-8-map":
        return write_sunras(sunras_rows(g >> 4, 8), w, h, 8, 1, colormap=pal.T)
    if name == "sun-24":
        return write_sunras(sunras_rows(rgb[..., ::-1], 24), w, h, 24, 1)
    if name == "sun-32":
        return write_sunras(sunras_rows(np.concatenate([g[..., None], rgb[..., ::-1]], 2), 32),
                            w, h, 32, 1)
    if name == "sun-rle-8":
        return write_sunras(sunras_rle(sunras_rows(g >> 3, 8, pad=False)), w, h, 8, 2)
    if name == "sun-rgb-24":
        return write_sunras(sunras_rows(rgb, 24), w, h, 24, 3)
    raise ValueError(name)


RASTER = ("tiff-lzw-pred2-gray16-be", "tiff-deflate-tiles-rgb8", "tiff-packbits-planar-rgb16",
          "tiff-raw-miniswhite-bigtiff", "tiff-lzw-palette4", "tiff-cmyk-lzw", "tiff-g4-fillorder2",
          "tiff-g3-2d", "tiff-ccitt-rle", "tiff-jpeg-ycbcr420", "tiff-jpeg-gray",
          "tiff-float32-pred3", "tiff-int32", "tiff-orient3-tiles", "tiff-lzw-corrupt",
          "bmp-8-rle8", "bmp-4-rle4-delta", "bmp-24-topdown", "bmp-16-565",
          "bmp-32-v5-bitfields", "bmp-1-os2", "bmp-8-rle8-no-eob", "pgm-p5-maxval50",
          "pgm-p5-16", "pgm-p2-ascii", "ppm-p6", "ppm-p3-200", "pbm-p4", "pbm-p1",
          "pam-gray", "pam-rgb16", "pfm-gray", "sun-8-map", "sun-24", "sun-32",
          "sun-rle-8", "sun-rgb-24")


def raster_job(name: str, size, seed: int, out: str) -> str:
    """Write `raster_file`'s file as ``out`` (for chip_smoke.py's worker
    processes)."""
    with open(out, "wb") as f:
        f.write(raster_file(name, size, seed))
    return out


def timing_file(kind: str, size, seed: int = 25):
    """(file bytes, the gray image) of phase 19's timed files: a 16-bit LZW
    TIFF with the horizontal predictor ("tiff"), a P5 PGM ("pgm") or an
    8-bit BMP ("bmp") of an x-ray like image, and the plain PNG ("png") of
    its 8 bits."""
    from torch_mura_tree import encode_png, xray_like
    g = xray_like(np.random.default_rng(seed), *size)
    if kind == "tiff":
        g16 = g.astype(np.uint16) * 256 + 128
        return write_tiff(g16, bits=16, compression=5, predictor=2, rows_per_strip=16), g
    if kind == "pgm":
        return write_pnm(g, 5), g
    if kind == "bmp":
        gray_pal = np.stack([np.arange(256)] * 3, 1)
        return write_bmp(bmp_rows(g[::-1], 8), size[1], size[0], 8, palette=gray_pal), g
    if kind == "png":
        return encode_png(g, 0, 8), g
    raise ValueError(kind)


def timing_job(kind: str, size, seed: int, out: str) -> str:
    raw, want = timing_file(kind, size, seed)
    with open(out, "wb") as f:
        f.write(raw)
    np.save(out + ".npy", want)
    return out


def reencode_raster(gray: np.ndarray, kind: str) -> bytes:
    """The (H, W) uint8 image ``gray`` as a file of ``kind``: tiff16 (a
    16-bit LZW TIFF with the horizontal predictor, big-endian), pgm (P5)
    or bmp8 (8-bit, a gray palette); each reads back as ``gray``."""
    h, w = gray.shape
    if kind == "tiff16":
        return write_tiff(gray.astype(np.uint16) * 257, bits=16, compression=5, predictor=2,
                          order=">", rows_per_strip=8)
    if kind == "pgm":
        return write_pnm(gray, 5)
    if kind == "bmp8":
        return write_bmp(bmp_rows(gray[::-1], 8), w, h, 8,
                         palette=np.stack([np.arange(256)] * 3, 1))
    raise ValueError(kind)

# sha256 of load_grayscale's gray image (cv2, then PIL) for `raster_file`'s files
# at 390 x 320 (tests/test_torch_raster_formats.py pins them to the JAX package's
# reader)
RASTER_SHA256 = {
    "tiff-lzw-pred2-gray16-be": "98e88cb7cfc59e44ec32a714541b5babe6db6767bde42cc60e12ac3bd7c8e90d",
    "tiff-deflate-tiles-rgb8": "55e3dd2291fed206a864d3777336e59bec0f3e1708614561e1f29c84d4af3065",
    "tiff-packbits-planar-rgb16": "55e3dd2291fed206a864d3777336e59bec0f3e1708614561e1f29c84d4af3065",
    "tiff-raw-miniswhite-bigtiff": "1e18779a048df7fe6a969993c187f2d6804b45e625334f126dbb99bdecfa39b8",
    "tiff-lzw-palette4": "b68f02fc5da99010af55d5155f5be3e75dd51f3f09c67cb4513e16795f8f625a",
    "tiff-cmyk-lzw": "728a05950d98841eb43f004f2f8a544f72cf9b81bcaa18149ecb7939432ba54b",
    "tiff-g4-fillorder2": "acd837e8dead5d5db8a029142f899c1b4b28df42c76b6dfee0472065d7d326c2",
    "tiff-g3-2d": "acd837e8dead5d5db8a029142f899c1b4b28df42c76b6dfee0472065d7d326c2",
    "tiff-ccitt-rle": "acd837e8dead5d5db8a029142f899c1b4b28df42c76b6dfee0472065d7d326c2",
    "tiff-jpeg-ycbcr420": "b9dbb89332e2861c6b9a6da32f00451a3a3bcf73ecfa308e38e36d0c474f65a8",
    "tiff-jpeg-gray": "d9dbfb54cfb28d4fd8682616eb45103204e2246a2d17b93344e075d5ddec6f4d",
    "tiff-float32-pred3": "99413bc5ac244cd094887eafbd471991be48b8eacb1b06a223718f7b78018edb",
    "tiff-int32": "553276f3db4d6d04ac0841895b94c32c17f16cf0034e8de58ee143782db0681b",
    "tiff-orient3-tiles": "c7433d88cd81f7e6881b681f193e5ee88788de8d5f6afb4ef1e85a6d3e514f5f",
    "tiff-lzw-corrupt": "8722d0ca1baf8c0a064e41b7f98feaae26534d09a4e2ad89d49b2c9d4b9417b6",
    "bmp-8-rle8": "3563199c33e35a3cd4c39f5b073f7ea67cc379ba83c37ea46b6756c873c85995",
    "bmp-4-rle4-delta": "53bba62f7e27b2faf1765f9e8353a56c90aac074e2d5ce4781f762b7e1abd053",
    "bmp-24-topdown": "55e3dd2291fed206a864d3777336e59bec0f3e1708614561e1f29c84d4af3065",
    "bmp-16-565": "de8d9ab4046a87c3684db4345389b5225331b8604a79a4973ac62ae1dfb15eba",
    "bmp-32-v5-bitfields": "bf3c0f318bb2b0dbc2febd7f4d43696019d596dee6c36e5e6e27c96e10577164",
    "bmp-1-os2": "cac3b9dcbbee2b91d1c2a7fcbf815bb037957d9f1dd057bd10c1ec4b75832735",
    "bmp-8-rle8-no-eob": "b68f02fc5da99010af55d5155f5be3e75dd51f3f09c67cb4513e16795f8f625a",
    "pgm-p5-maxval50": "56f3f35c3b47ec79b51524c8020507143621c88298a6af810f0bab08f146ad32",
    "pgm-p5-16": "98e88cb7cfc59e44ec32a714541b5babe6db6767bde42cc60e12ac3bd7c8e90d",
    "pgm-p2-ascii": "851dc3477de3720596404a1ba12ec742191dc27199e2d3604be6d73700d2b249",
    "ppm-p6": "55e3dd2291fed206a864d3777336e59bec0f3e1708614561e1f29c84d4af3065",
    "ppm-p3-200": "c55b959f302218604234521545f191da4008bf4a26b65a986d8b89c29f1179a8",
    "pbm-p4": "acd837e8dead5d5db8a029142f899c1b4b28df42c76b6dfee0472065d7d326c2",
    "pbm-p1": "acd837e8dead5d5db8a029142f899c1b4b28df42c76b6dfee0472065d7d326c2",
    "pam-gray": "adf2c2e723f6b7146d7a2ff8a75d319311683ca54b472ed4cd3d34e588f9040e",
    "pam-rgb16": "55e3dd2291fed206a864d3777336e59bec0f3e1708614561e1f29c84d4af3065",
    "pfm-gray": "adf2c2e723f6b7146d7a2ff8a75d319311683ca54b472ed4cd3d34e588f9040e",
    "sun-8-map": "b68f02fc5da99010af55d5155f5be3e75dd51f3f09c67cb4513e16795f8f625a",
    "sun-24": "55e3dd2291fed206a864d3777336e59bec0f3e1708614561e1f29c84d4af3065",
    "sun-32": "55e3dd2291fed206a864d3777336e59bec0f3e1708614561e1f29c84d4af3065",
    "sun-rle-8": "5c7fc4c016f0cb43f7e38dd6a05b43c22a4b4942699fc63ca3a53161f5a5e306",
    "sun-rgb-24": "56644ca41cc0eb41dcdfac4f95f28a0cb1df925687abe53b006e647301c020bd",
}


def ycbcr_blocks(ycc: np.ndarray, hs: int, vs: int, rows: int) -> list:
    """Uncompressed subsampled YCbCr strips of ``rows`` rows of the (H, W, 3)
    planes: blocks of hs x vs lumas then the block's first Cb and Cr."""
    h, w, _ = ycc.shape
    strips = []
    for y0 in range(0, h, rows):
        out = bytearray()
        part = ycc[y0:y0 + rows]
        for by in range(0, part.shape[0], vs):
            for bx in range(0, w, hs):
                blk = np.zeros((vs, hs), np.uint8)
                sub = part[by:by + vs, bx:bx + hs, 0]
                blk[:sub.shape[0], :sub.shape[1]] = sub
                out += blk.tobytes() + bytes([int(part[by, bx, 1]), int(part[by, bx, 2])])
        strips.append(bytes(out))
    return strips
