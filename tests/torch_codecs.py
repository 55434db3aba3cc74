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
