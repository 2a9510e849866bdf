"""From-scratch JPEG 2000 Part 1 reader (5/3 lossless + 9/7 lossy).

Counterpart of ``nd_tpu/io/jp2.py``, host numpy as there: the JP2
container boxes, the codestream (SIZ/COD/COC/QCD/QCC/SOT tile-parts),
Tier-2 packet headers (tag trees, SOP/EPH, precincts, LRCP/RLCP/RPCL
progressions), Tier-1 EBCOT code-block decoding (MQ arithmetic coder,
the three coding passes), both wavelet syntheses — the reversible
integer 5/3 and the irreversible floating 9/7 with Annex E scalar
dequantization (derived and expounded) and mid-bin reconstruction —
and both color transforms (RCT and ICT). Rare coding-style extensions
raise a loud, specific error instead of approximating.

Tier-1 runs in the port's native decoder (``nd_tpu_torch/native``,
C++ built with the host compiler at first use; a failed build raises)
unless the caller passes ``t1='python'``: :class:`_T1Decoder` is the
readable specification that the native decoder is held to, bit for bit.
"""

from __future__ import annotations

import math
import struct

import numpy as np

__all__ = ['decode_jp2', 'decode_codestream', 'codeblock_jobs',
           'Jp2Error']


class Jp2Error(ValueError):
    pass


# ---------------------------------------------------------------------------
# MQ arithmetic decoder (ISO/IEC 15444-1 Annex C)
# ---------------------------------------------------------------------------

_QE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# T1 context slots: 0-8 significance, 9-13 sign, 14-16 refinement,
# 17 run-length, 18 uniform
_N_CTX = 19
_CTX_RL = 17
_CTX_UNI = 18


class _MQDecoder:
    """One codeword segment; contexts are [index, mps] pairs."""

    __slots__ = ('data', 'bp', 'c', 'a', 'ct', 'n')

    def __init__(self, data):
        self.data = data
        self.n = len(data)
        self.bp = 0
        b0 = data[0] if self.n else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c <<= 7
        self.ct -= 7
        self.a = 0x8000

    def _byte(self, i):
        return self.data[i] if i < self.n else 0xFF

    def _bytein(self):
        if self._byte(self.bp) == 0xFF:
            if self._byte(self.bp + 1) > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self._byte(self.bp) << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self._byte(self.bp) << 8
            self.ct = 8

    def decode(self, cx):
        qe, nmps, nlps, switch = _QE[cx[0]]
        self.a -= qe
        if (self.c >> 16) < qe:
            # LPS exchange path
            if self.a < qe:
                d = cx[1]
                cx[0] = nmps
            else:
                d = 1 - cx[1]
                if switch:
                    cx[1] = 1 - cx[1]
                cx[0] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return cx[1]
            if self.a < qe:
                d = 1 - cx[1]
                if switch:
                    cx[1] = 1 - cx[1]
                cx[0] = nlps
            else:
                d = cx[1]
                cx[0] = nmps
        # renormalize
        while True:
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# ---------------------------------------------------------------------------
# Packet-header bit reader (bit stuffing after 0xFF) and tag trees
# ---------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.cnt = 0
        self.last = 0

    def bit(self):
        if self.cnt == 0:
            if self.last == 0xFF:
                self.buf = self.data[self.pos]
                self.pos += 1
                if self.buf & 0x80:
                    raise Jp2Error('packet header bit-stuffing violation')
                self.cnt = 7
            else:
                self.buf = self.data[self.pos]
                self.pos += 1
                self.cnt = 8
            self.last = self.buf
        self.cnt -= 1
        return (self.buf >> self.cnt) & 1

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        """Terminate the header: drop to the next byte boundary (a
        stuffed 0 bit after a final 0xFF is consumed)."""
        self.cnt = 0
        if self.last == 0xFF:
            # the aligner must skip the stuffing byte
            self.pos += 1
        self.last = 0


class _TagTree:
    def __init__(self, w, h):
        self.dims = []
        while True:
            self.dims.append((w, h))
            if w == 1 and h == 1:
                break
            w = (w + 1) // 2
            h = (h + 1) // 2
        self.low = [np.zeros((h_, w_), np.int32) for w_, h_ in self.dims]
        self.val = [np.full((h_, w_), -1, np.int32)
                    for w_, h_ in self.dims]

    def decode(self, br, i, j, threshold):
        """Walk toward leaf (i, j); return the leaf value if it is
        known and < threshold, else None (meaning >= threshold)."""
        path = []
        for lvl in range(len(self.dims)):
            path.append((lvl, i >> lvl, j >> lvl))
        low = 0
        for lvl, ii, jj in reversed(path):
            lo = self.low[lvl]
            va = self.val[lvl]
            if lo[jj, ii] < low:
                lo[jj, ii] = low
            while va[jj, ii] < 0 and lo[jj, ii] < threshold:
                if br.bit():
                    va[jj, ii] = lo[jj, ii]
                else:
                    lo[jj, ii] += 1
            if va[jj, ii] >= 0:
                low = va[jj, ii]
                continue
            return None
        return int(low)

    def decode_value(self, br, i, j):
        """Decode until the leaf value is fully known."""
        t = 1
        while True:
            v = self.decode(br, i, j, t)
            if v is not None:
                return v
            t += 1


# ---------------------------------------------------------------------------
# Tier-1: EBCOT code-block decoding (Annex D)
# ---------------------------------------------------------------------------

# significance context tables per band orientation, indexed [h][v][d]
def _build_sig_tables():
    lh = np.zeros((3, 3, 5), np.int8)
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if h == 2:
                    c = 8
                elif h == 1:
                    c = 7 if v >= 1 else (6 if d >= 1 else 5)
                elif v == 2:
                    c = 4
                elif v == 1:
                    c = 3
                else:
                    c = 2 if d >= 2 else (1 if d == 1 else 0)
                lh[h, v, d] = c
    hh = np.zeros((5, 5), np.int8)   # [h+v][d]
    for hv in range(5):
        for d in range(5):
            if d >= 3:
                c = 8
            elif d == 2:
                c = 7 if hv >= 1 else 6
            elif d == 1:
                c = 5 if hv >= 2 else (4 if hv == 1 else 3)
            else:
                c = 2 if hv >= 2 else (1 if hv == 1 else 0)
            hh[hv, d] = c
    return lh, hh


_SIG_LH, _SIG_HH = _build_sig_tables()

# sign context/xor from clamped (H, V) in {-1, 0, 1}
_SIGN_CTX = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
             (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
             (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}


class _T1Decoder:
    """Decode one code-block's coding passes into signed integers."""

    def __init__(self, w, h, orientation):
        self.w = w
        self.h = h
        self.orient = orientation          # 'LL','LH','HL','HH'
        # padded state planes (1-cell ring)
        self.sig = np.zeros((h + 2, w + 2), np.uint8)
        self.sgn = np.zeros((h + 2, w + 2), np.int8)
        self.visited = np.zeros((h + 2, w + 2), np.uint8)
        self.refined = np.zeros((h + 2, w + 2), np.uint8)
        self.mag = np.zeros((h + 2, w + 2), np.int64)
        # bit-plane of each coefficient's most recent interval update
        # (significance or refinement, regardless of the bit value) —
        # the 9/7 reconstruction offset is half that plane's step
        self.lastp = np.zeros((h + 2, w + 2), np.int16)

    def _sig_ctx(self, y, x):
        s = self.sig
        hsum = int(s[y, x - 1]) + int(s[y, x + 1])
        vsum = int(s[y - 1, x]) + int(s[y + 1, x])
        dsum = (int(s[y - 1, x - 1]) + int(s[y - 1, x + 1])
                + int(s[y + 1, x - 1]) + int(s[y + 1, x + 1]))
        o = self.orient
        if o == 'HH':
            return int(_SIG_HH[hsum + vsum, dsum])
        if o == 'HL':
            hsum, vsum = vsum, hsum
        return int(_SIG_LH[hsum, vsum, dsum])

    def _decode_sign(self, mq, cx, y, x):
        s, g = self.sig, self.sgn
        hc = (int(s[y, x - 1]) * int(g[y, x - 1])
              + int(s[y, x + 1]) * int(g[y, x + 1]))
        vc = (int(s[y - 1, x]) * int(g[y - 1, x])
              + int(s[y + 1, x]) * int(g[y + 1, x]))
        hc = max(-1, min(1, hc))
        vc = max(-1, min(1, vc))
        ctx, xo = _SIGN_CTX[(hc, vc)]
        bit = mq.decode(cx[ctx])
        return -1 if (bit ^ xo) else 1

    def sig_prop_pass(self, mq, cx, bp):
        one = np.int64(1) << bp
        for y0 in range(1, self.h + 1, 4):
            for x in range(1, self.w + 1):
                for y in range(y0, min(y0 + 4, self.h + 1)):
                    if self.sig[y, x]:
                        continue
                    ctx = self._sig_ctx(y, x)
                    if ctx == 0:
                        continue
                    self.visited[y, x] = 1
                    if mq.decode(cx[ctx]):
                        self.sig[y, x] = 1
                        self.mag[y, x] |= one
                        self.lastp[y, x] = bp
                        self.sgn[y, x] = self._decode_sign(mq, cx, y, x)

    def mag_ref_pass(self, mq, cx, bp):
        one = np.int64(1) << bp
        for y0 in range(1, self.h + 1, 4):
            for x in range(1, self.w + 1):
                for y in range(y0, min(y0 + 4, self.h + 1)):
                    if not self.sig[y, x] or self.visited[y, x]:
                        continue
                    if self.refined[y, x]:
                        ctx = 16
                    else:
                        s = self.sig
                        any_nb = (int(s[y, x - 1]) + int(s[y, x + 1])
                                  + int(s[y - 1, x]) + int(s[y + 1, x])
                                  + int(s[y - 1, x - 1])
                                  + int(s[y - 1, x + 1])
                                  + int(s[y + 1, x - 1])
                                  + int(s[y + 1, x + 1]))
                        ctx = 15 if any_nb else 14
                    if mq.decode(cx[ctx]):
                        self.mag[y, x] |= one
                    self.refined[y, x] = 1
                    self.lastp[y, x] = bp

    def cleanup_pass(self, mq, cx, bp):
        one = np.int64(1) << bp
        for y0 in range(1, self.h + 1, 4):
            full = y0 + 3 <= self.h
            for x in range(1, self.w + 1):
                y = y0
                if full:
                    rl = (not any(self.sig[y0 + k, x] or
                                  self.visited[y0 + k, x]
                                  for k in range(4))) and \
                        all(self._sig_ctx(y0 + k, x) == 0
                            for k in range(4))
                    if rl:
                        if not mq.decode(cx[_CTX_RL]):
                            continue
                        r = (mq.decode(cx[_CTX_UNI]) << 1) \
                            | mq.decode(cx[_CTX_UNI])
                        y = y0 + r
                        self.sig[y, x] = 1
                        self.mag[y, x] |= one
                        self.lastp[y, x] = bp
                        self.sgn[y, x] = self._decode_sign(mq, cx, y, x)
                        y += 1
                while y < min(y0 + 4, self.h + 1):
                    if not self.sig[y, x] and not self.visited[y, x]:
                        if mq.decode(cx[self._sig_ctx(y, x)]):
                            self.sig[y, x] = 1
                            self.mag[y, x] |= one
                            self.lastp[y, x] = bp
                            self.sgn[y, x] = \
                                self._decode_sign(mq, cx, y, x)
                    y += 1
        self.visited[:] = 0

    def decode(self, data, npasses, numbps):
        """Run ``npasses`` coding passes starting at bit-plane
        ``numbps - 1`` (cleanup first)."""
        if npasses == 0 or numbps <= 0:
            return np.zeros((self.h, self.w), np.int64)
        mq = _MQDecoder(data)
        cx = [[0, 0] for _ in range(_N_CTX)]
        cx[_CTX_UNI][0] = 46
        cx[_CTX_RL][0] = 3
        cx[0][0] = 4
        bp = numbps - 1
        passno = 0
        kind = 2                        # first pass is a cleanup
        while passno < npasses:
            if kind == 0:
                self.sig_prop_pass(mq, cx, bp)
            elif kind == 1:
                self.mag_ref_pass(mq, cx, bp)
            else:
                self.cleanup_pass(mq, cx, bp)
                bp -= 1
                if bp < 0 and passno + 1 < npasses:
                    raise Jp2Error('more coding passes than bit-planes')
            passno += 1
            kind = (kind + 1) % 3
        vals = self.mag[1:-1, 1:-1] * self.sgn[1:-1, 1:-1]
        return vals

    def recon_real(self):
        """Deadzone mid-bin reconstruction for the 9/7 path: each
        significant coefficient reconstructs at the midpoint of its
        remaining uncertainty interval, |q| + 0.5 * 2^lastp (lastp =
        the bit-plane of its last significance/refinement update) —
        matching OpenJPEG's running half-step adjustments in closed
        form. Truncated layers thus reconstruct mid-interval instead
        of at the bin edge (~1 dB on typical content)."""
        return _recon_real(self.mag[1:-1, 1:-1]
                           * self.sgn[1:-1, 1:-1],
                           self.lastp[1:-1, 1:-1])


def _recon_real(vals, lastp):
    """Mid-bin reconstruction from signed integer coefficients and
    their last-updated bit-planes (see ``_T1Decoder.recon_real``)."""
    mag = np.abs(vals).astype(np.float64)
    half = np.ldexp(0.5, np.asarray(lastp, np.int64))
    return np.where(mag > 0, mag + half, 0.0) * np.sign(vals)


T1_ROUTES = ('native', 'python')


def _t1_decode_many(jobs, t1='native'):
    """Tier-1 decode of many code-blocks: ``jobs`` rows are
    ``(buf, w, h, otype, npasses, numbps)`` -> list of
    ``(vals, lastp)`` in order. ``t1='native'`` decodes them in the
    native batch decoder (independent blocks fan out over OpenMP
    threads); ``t1='python'`` in :class:`_T1Decoder`."""
    if t1 == 'native':
        from ..native import jp2_t1_decode_batch
        return jp2_t1_decode_batch(jobs)
    if t1 != 'python':
        raise ValueError('t1=%r: expected one of %s' % (t1, T1_ROUTES))
    out = []
    for buf, w, h, otype, npasses, numbps in jobs:
        t1d = _T1Decoder(w, h, otype)
        vals = t1d.decode(buf, npasses, numbps)
        out.append((vals, t1d.lastp[1:-1, 1:-1].copy()))
    return out


# ---------------------------------------------------------------------------
# Codestream structures
# ---------------------------------------------------------------------------

class _Band:
    __slots__ = ('otype', 'x0', 'y0', 'x1', 'y1', 'mb', 'cbs',
                 'incl_tree', 'msbs_tree', 'cbw', 'cbh', 'cbx0',
                 'cby0', 'ncbx', 'ncby', 'xob', 'yob', 'delta')


class _CodeBlock:
    __slots__ = ('x0', 'y0', 'x1', 'y1', 'included', 'numbps',
                 'lblock', 'segments', 'npasses')

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included = False
        self.numbps = 0
        self.lblock = 3
        self.segments = []              # (bytes, npasses)
        self.npasses = 0


def _ceil_div(a, b):
    return -(-a // b)


class _Codestream:
    pass


def _parse_markers(buf):
    """Parse the main header + tile-parts of a raw codestream."""
    cs = _Codestream()
    if buf[:2] != b'\xff\x4f':
        raise Jp2Error('not a JPEG 2000 codestream (missing SOC)')
    pos = 2
    cs.tile_parts = []
    cs.coms = []
    main = True
    cs.cod = None
    cs.qcd = None
    cs.qcc = {}
    cs.coc = {}
    while pos < len(buf):
        marker = buf[pos:pos + 2]
        pos += 2
        if marker == b'\xff\xd9':       # EOC
            break
        if marker == b'\xff\x93':       # SOD
            # tile-part body runs to the next SOT or EOC
            start = pos
            end = cs._cur_end
            cs.tile_parts.append((cs._cur_tile, buf[start:end]))
            pos = end
            main = False
            continue
        if pos + 2 > len(buf):
            raise Jp2Error('truncated codestream')
        (ln,) = struct.unpack('>H', buf[pos:pos + 2])
        seg = buf[pos + 2:pos + ln]
        m = marker[1]
        if m == 0x51:                   # SIZ
            (cs.rsiz, cs.xsiz, cs.ysiz, cs.xosiz, cs.yosiz,
             cs.xtsiz, cs.ytsiz, cs.xtosiz, cs.ytosiz,
             cs.ncomp) = struct.unpack('>HIIIIIIIIH', seg[:36])
            cs.comps = []
            for c in range(cs.ncomp):
                ssiz, xr, yr = struct.unpack(
                    '>BBB', seg[36 + 3 * c:39 + 3 * c])
                cs.comps.append({'prec': (ssiz & 0x7F) + 1,
                                 'signed': bool(ssiz & 0x80),
                                 'xr': xr, 'yr': yr})
        elif m == 0x52:                 # COD
            cs.cod = _parse_cod(seg)
        elif m == 0x5C:                 # QCD
            cs.qcd = _parse_qcd(seg)
        elif m == 0x53:                 # COC
            cidx = seg[0] if cs.ncomp < 257 else \
                struct.unpack('>H', seg[:2])[0]
            off = 1 if cs.ncomp < 257 else 2
            cs.coc[cidx] = _parse_cod(seg[off:], coc=True)
        elif m == 0x5D:                 # QCC
            cidx = seg[0] if cs.ncomp < 257 else \
                struct.unpack('>H', seg[:2])[0]
            off = 1 if cs.ncomp < 257 else 2
            cs.qcc[cidx] = _parse_qcd(seg[off:])
        elif m == 0x90:                 # SOT
            isot, psot, tpsot, tnsot = struct.unpack(
                '>HIBB', seg[:8])
            cs._cur_tile = isot
            # Psot counts from the SOT marker itself; 0 = to EOC
            cs._cur_end = (pos - 2 + psot) if psot else (len(buf) - 2)
        elif m == 0x64:                 # COM
            cs.coms.append(seg)
        elif m in (0x5e, 0x5f, 0x60, 0x61):
            # RGN (ROI) / POC / PPM / PPT change decoding semantics
            raise Jp2Error(
                'marker 0xFF%02X (RGN/POC/PPM/PPT) is not supported '
                'by this reader' % m)
        # TLM (0x55) / PLM (0x57) / PLT (0x58) / CRG (0x63) are
        # advisory pointer/registration segments — skipped
        pos += ln
    if cs.cod is None or cs.qcd is None:
        raise Jp2Error('missing COD/QCD in main header')
    return cs


def _parse_cod(seg, coc=False):
    cod = {}
    scod = seg[0]
    cod['precincts_defined'] = bool(scod & 1)
    cod['sop'] = bool(scod & 2)
    cod['eph'] = bool(scod & 4)
    if coc:
        off = 1
        cod['prog'] = None
        cod['layers'] = None
        cod['mct'] = None
    else:
        cod['prog'], cod['layers'], cod['mct'] = struct.unpack(
            '>BHB', seg[1:5])
        off = 5
    nl, xcb, ycb, cbstyle, wavelet = struct.unpack(
        '>BBBBB', seg[off:off + 5])
    cod['nl'] = nl
    cod['xcb'] = (xcb & 0xF) + 2
    cod['ycb'] = (ycb & 0xF) + 2
    cod['cbstyle'] = cbstyle
    cod['wavelet'] = wavelet            # 0 = 9/7, 1 = 5/3
    if cod['precincts_defined']:
        pp = seg[off + 5:off + 5 + nl + 1]
        cod['pp'] = [(b & 0xF, b >> 4) for b in pp]
    else:
        cod['pp'] = [(15, 15)] * (nl + 1)
    return cod


def _parse_qcd(seg):
    sqcd = seg[0]
    style = sqcd & 0x1F
    guard = sqcd >> 5
    q = {'style': style, 'guard': guard}
    body = seg[1:]
    if style == 0:                      # no quantization (reversible)
        q['exps'] = [b >> 3 for b in body]
    elif style == 1:                    # scalar derived
        val = struct.unpack('>H', body[:2])[0]
        q['exps'] = [val >> 11]
        q['mants'] = [val & 0x7FF]
    else:                               # scalar expounded
        q['exps'] = []
        q['mants'] = []
        for i in range(0, len(body), 2):
            val = struct.unpack('>H', body[i:i + 2])[0]
            q['exps'].append(val >> 11)
            q['mants'].append(val & 0x7FF)
    return q


# ---------------------------------------------------------------------------
# Tier-2: packet decoding over a tile
# ---------------------------------------------------------------------------

def _tile_grid(cs, tidx):
    ntx = _ceil_div(cs.xsiz - cs.xtosiz, cs.xtsiz)
    p, q = tidx % ntx, tidx // ntx
    tx0 = max(cs.xtosiz + p * cs.xtsiz, cs.xosiz)
    ty0 = max(cs.ytosiz + q * cs.ytsiz, cs.yosiz)
    tx1 = min(cs.xtosiz + (p + 1) * cs.xtsiz, cs.xsiz)
    ty1 = min(cs.ytosiz + (q + 1) * cs.ytsiz, cs.ysiz)
    return tx0, ty0, tx1, ty1


def _build_tile(cs, tidx):
    """Resolution/band/code-block geometry for one tile."""
    tx0, ty0, tx1, ty1 = _tile_grid(cs, tidx)
    tile = {'comps': []}
    for c in range(cs.ncomp):
        cod = cs.coc.get(c, cs.cod)
        q = cs.qcc.get(c, cs.qcd)
        irrev = cod['wavelet'] == 0
        if irrev and q['style'] == 0:
            raise Jp2Error(
                'irreversible 9/7 transform with no-quantization '
                'style (Sqcd=0) is not a valid Part 1 combination')
        if not irrev and q['style'] != 0:
            raise Jp2Error(
                'reversible 5/3 transform with scalar quantization '
                'is not supported (Part 1 pairs 5/3 with Sqcd=0)')
        xr, yr = cs.comps[c]['xr'], cs.comps[c]['yr']
        tcx0, tcy0 = _ceil_div(tx0, xr), _ceil_div(ty0, yr)
        tcx1, tcy1 = _ceil_div(tx1, xr), _ceil_div(ty1, yr)
        nl = cod['nl']
        comp = {'x0': tcx0, 'y0': tcy0, 'x1': tcx1, 'y1': tcy1,
                'nl': nl, 'resolutions': [], 'cod': cod,
                'irrev': irrev}
        exps = q['exps']
        mants = q.get('mants')
        guard = q['guard']
        prec = cs.comps[c]['prec']
        _GAIN = {'LL': 0, 'HL': 1, 'LH': 1, 'HH': 2}
        for r in range(nl + 1):
            dshift = nl - r
            trx0 = _ceil_div(tcx0, 1 << dshift)
            try0 = _ceil_div(tcy0, 1 << dshift)
            trx1 = _ceil_div(tcx1, 1 << dshift)
            try1 = _ceil_div(tcy1, 1 << dshift)
            ppx, ppy = cod['pp'][r]
            res = {'x0': trx0, 'y0': try0, 'x1': trx1, 'y1': try1,
                   'ppx': ppx, 'ppy': ppy, 'bands': []}
            if trx1 > trx0:
                res['npw'] = _ceil_div(trx1, 1 << ppx) \
                    - (trx0 >> ppx)
            else:
                res['npw'] = 0
            if try1 > try0:
                res['nph'] = _ceil_div(try1, 1 << ppy) \
                    - (try0 >> ppy)
            else:
                res['nph'] = 0
            # codeblock size within this resolution
            if r == 0:
                xcb = min(cod['xcb'], ppx)
                ycb = min(cod['ycb'], ppy)
                borders = [('LL', 0, 0, 0)]
            else:
                xcb = min(cod['xcb'], ppx - 1)
                ycb = min(cod['ycb'], ppy - 1)
                borders = [('HL', 1, 0, r), ('LH', 0, 1, r),
                           ('HH', 1, 1, r)]
            res['xcb'] = xcb
            res['ycb'] = ycb
            for bi, (otype, xob, yob, _) in enumerate(borders):
                band = _Band()
                band.otype = otype
                band.xob = xob
                band.yob = yob
                if r == 0:
                    band.x0, band.y0 = trx0, try0
                    band.x1, band.y1 = trx1, try1
                    eidx = 0
                else:
                    d = nl - r + 1
                    band.x0 = _ceil_div(tcx0 - (1 << (d - 1)) * xob,
                                        1 << d)
                    band.y0 = _ceil_div(tcy0 - (1 << (d - 1)) * yob,
                                        1 << d)
                    band.x1 = _ceil_div(tcx1 - (1 << (d - 1)) * xob,
                                        1 << d)
                    band.y1 = _ceil_div(tcy1 - (1 << (d - 1)) * yob,
                                        1 << d)
                    eidx = 3 * (r - 1) + bi + 1
                if q['style'] == 1:
                    # scalar derived (Annex E, E-5): one exponent for
                    # the NL-th level LL, halved grids derive the rest
                    eps_b = exps[0] - (r - 1 if r else 0)
                    mu_b = mants[0]
                elif q['style'] == 2:       # scalar expounded
                    eps_b = exps[eidx]
                    mu_b = mants[eidx]
                else:                       # no quantization (5/3)
                    eps_b = exps[eidx]
                    mu_b = 0
                band.mb = eps_b + guard - 1
                if irrev:
                    # Annex E dequantization step for this band:
                    # delta = 2^(Rb - eps_b) * (1 + mu_b / 2^11),
                    # Rb = component precision + log2 subband gain
                    rb = prec + _GAIN[otype]
                    band.delta = (2.0 ** (rb - eps_b)
                                  * (1.0 + mu_b / 2048.0))
                band.cbw = 1 << xcb
                band.cbh = 1 << ycb
                band.cbx0 = band.x0 >> xcb
                band.cby0 = band.y0 >> ycb
                if band.x1 > band.x0:
                    band.ncbx = _ceil_div(band.x1, band.cbw) \
                        - band.cbx0
                    band.ncby = _ceil_div(band.y1, band.cbh) \
                        - band.cby0
                else:
                    band.ncbx = band.ncby = 0
                band.cbs = {}
                band.incl_tree = {}
                band.msbs_tree = {}
                res['bands'].append(band)
            comp['resolutions'].append(res)
        tile['comps'].append(comp)
    return tile, (tx0, ty0, tx1, ty1)


def _precinct_cbs(band, res, pi, pj):
    """Code-blocks of precinct (pi, pj) within ``band``, raster order,
    with the precinct's tag trees created on first use."""
    ppx, ppy = res['ppx'], res['ppy']
    px0 = ((res['x0'] >> ppx) + pi) << ppx
    py0 = ((res['y0'] >> ppy) + pj) << ppy
    px1 = min(px0 + (1 << ppx), res['x1'])
    py1 = min(py0 + (1 << ppy), res['y1'])
    px0 = max(px0, res['x0'])
    py0 = max(py0, res['y0'])
    if band.otype == 'LL':
        bx0, by0, bx1, by1 = px0, py0, px1, py1
    else:
        # band sample b sits at resolution coordinate 2b + xob
        bx0 = _ceil_div(px0 - band.xob, 2)
        by0 = _ceil_div(py0 - band.yob, 2)
        bx1 = _ceil_div(px1 - band.xob, 2)
        by1 = _ceil_div(py1 - band.yob, 2)
    bx0 = max(bx0, band.x0)
    by0 = max(by0, band.y0)
    bx1 = min(bx1, band.x1)
    by1 = min(by1, band.y1)
    if bx1 <= bx0 or by1 <= by0:
        return [], None, None
    ci0 = bx0 // band.cbw
    cj0 = by0 // band.cbh
    ci1 = _ceil_div(bx1, band.cbw)
    cj1 = _ceil_div(by1, band.cbh)
    key = (pi, pj)
    if key not in band.incl_tree:
        band.incl_tree[key] = _TagTree(ci1 - ci0, cj1 - cj0)
        band.msbs_tree[key] = _TagTree(ci1 - ci0, cj1 - cj0)
    out = []
    for cj in range(cj0, cj1):
        for ci in range(ci0, ci1):
            k = (ci, cj)
            if k not in band.cbs:
                x0 = max(ci * band.cbw, bx0)
                y0 = max(cj * band.cbh, by0)
                x1 = min((ci + 1) * band.cbw, bx1)
                y1 = min((cj + 1) * band.cbh, by1)
                band.cbs[k] = _CodeBlock(x0, y0, x1, y1)
            out.append(((ci - ci0, cj - cj0), band.cbs[k]))
    return out, band.incl_tree[key], band.msbs_tree[key]


def _decode_npasses(br):
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    v = br.bits(2)
    if v < 3:
        return 3 + v
    v = br.bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.bits(7)


def _decode_packet(data, pos, layer, res, sop, eph, sop_count):
    """Decode one packet header at ``pos``; returns new position and
    the list of (codeblock, nbytes, npasses) body contributions."""
    if sop and data[pos:pos + 2] == b'\xff\x91':
        pos += 6
    br = _BitReader(data, pos)
    contributions = []
    if not br.bit():                    # zero-length packet
        br.align()
        pos = br.pos
        if eph:
            if data[pos:pos + 2] != b'\xff\x92':
                raise Jp2Error('missing EPH marker')
            pos += 2
        return pos, contributions
    npw, nph = res['npw'], res['nph']
    pi, pj = res['_cur_precinct']
    for band in res['bands']:
        if band.x1 <= band.x0 or band.y1 <= band.y0:
            continue
        cbs, incl_tree, msbs_tree = _precinct_cbs(band, res, pi, pj)
        for (ti, tj), cb in cbs:
            if cb.included:
                included = bool(br.bit())
            else:
                v = incl_tree.decode(br, ti, tj, layer + 1)
                included = v is not None and v <= layer
            if not included:
                continue
            if not cb.included:
                cb.included = True
                k = msbs_tree.decode_value(br, ti, tj)
                cb.numbps = band.mb - k
                if cb.numbps < 0:
                    raise Jp2Error('invalid zero bit-plane count')
            npasses = _decode_npasses(br)
            while br.bit():
                cb.lblock += 1
            nbits = cb.lblock + int(math.floor(math.log2(npasses)))
            nbytes = br.bits(nbits)
            contributions.append((cb, nbytes, npasses))
    br.align()
    pos = br.pos
    if eph:
        if data[pos:pos + 2] != b'\xff\x92':
            raise Jp2Error('missing EPH marker')
        pos += 2
    return pos, contributions


def _packet_iterator(cs, tile):
    """Yield (layer, res, comp) packet order per the progression."""
    cod = cs.cod
    prog = cod['prog']
    layers = cod['layers']
    ncomp = cs.ncomp
    maxres = max(len(c['resolutions']) for c in tile['comps'])

    def precincts(c, r):
        if r >= len(tile['comps'][c]['resolutions']):
            return
        res = tile['comps'][c]['resolutions'][r]
        for pj in range(res['nph']):
            for pi in range(res['npw']):
                yield res, (pi, pj)

    if prog == 0:                       # LRCP
        for l in range(layers):
            for r in range(maxres):
                for c in range(ncomp):
                    for res, p in precincts(c, r):
                        yield l, res, p
    elif prog == 1:                     # RLCP
        for r in range(maxres):
            for l in range(layers):
                for c in range(ncomp):
                    for res, p in precincts(c, r):
                        yield l, res, p
    elif prog == 2:                     # RPCL
        for r in range(maxres):
            # position-major: precinct raster order across components
            allp = []
            for c in range(ncomp):
                for res, p in precincts(c, r):
                    allp.append((p[1], p[0], c, res))
            for pj, pi, c, res in sorted(allp):
                for l in range(layers):
                    yield l, res, (pi, pj)
    else:
        raise Jp2Error('progression order %d is not supported '
                       '(LRCP/RLCP/RPCL only)' % prog)


def _tile_codeblocks(cs, tidx, data, reduce=0):
    """Tier-2 of one tile: its packets read into the code-blocks, then
    for each component the band arrays to fill (int64 coefficients for
    the reversible path, Annex E dequantized float64 for 9/7) and the
    Tier-1 jobs of every code-block of every kept resolution, with
    where each goes. Returns ``(tile, trect, comps)``, ``comps`` a list
    of ``(band_arrays, jobs, places, keep, irrev)``."""
    tile, trect = _build_tile(cs, tidx)
    cod = cs.cod
    pos = 0
    for layer, res, p in _packet_iterator(cs, tile):
        res['_cur_precinct'] = p
        pos, contribs = _decode_packet(data, pos, layer, res,
                                       cod['sop'], cod['eph'], 0)
        for cb, nbytes, npasses in contribs:
            cb.segments.append((data[pos:pos + nbytes], npasses))
            pos += nbytes
    comps = []
    for comp in tile['comps']:
        keep = max(comp['nl'] - reduce, 0)
        irrev = comp['irrev']
        band_arrays = {}
        jobs = []
        places = []          # (band, arr, cb) aligned with jobs
        for r, res in enumerate(comp['resolutions']):
            if r > keep:
                continue            # reduced decode: skip Tier-1 for
                                    # resolutions beyond the target
            for band in res['bands']:
                bw = band.x1 - band.x0
                bh = band.y1 - band.y0
                arr = np.zeros((bh, bw),
                               np.float64 if irrev else np.int64)
                band_arrays[(r, band.otype)] = (band, arr)
                for (ci, cj), cb in band.cbs.items():
                    w = cb.x1 - cb.x0
                    h = cb.y1 - cb.y0
                    if w <= 0 or h <= 0 or not cb.segments:
                        continue
                    buf = b''.join(s for s, _ in cb.segments)
                    npasses = sum(n for _, n in cb.segments)
                    jobs.append((buf, w, h, band.otype, npasses,
                                 cb.numbps))
                    places.append((band, arr, cb))
        comps.append((band_arrays, jobs, places, keep, irrev))
    return tile, trect, comps


def _decode_tile(cs, tidx, data, reduce=0, t1='native'):
    tile, trect, comps = _tile_codeblocks(cs, tidx, data, reduce)
    # Tier-1 decode + assemble subbands, then synthesize: each
    # component's code-blocks go to Tier-1 in ONE batched call
    out_comps = []
    for c, (band_arrays, jobs, places, keep, irrev) in enumerate(comps):
        for (band, arr, cb), (vals, lastp) in zip(
                places, _t1_decode_many(jobs, t1)):
            if irrev:
                # Annex E dequantization of the mid-bin
                # reconstruction (see recon_real)
                vals = _recon_real(vals, lastp) * band.delta
            arr[cb.y0 - band.y0:cb.y1 - band.y0,
                cb.x0 - band.x0:cb.x1 - band.x0] = vals
        # multi-level synthesis
        synthesize = _synthesize_97 if irrev else _synthesize_53
        ll = band_arrays[(0, 'LL')][1]
        for r in range(1, keep + 1):
            res = tile['comps'][c]['resolutions'][r]
            ll = synthesize(ll, *(band_arrays[(r, o)][1]
                                  for o in ('HL', 'LH', 'HH')),
                            res['x0'], res['y0'], res['x1'], res['y1'])
        out_comps.append(ll)
    return tile, trect, out_comps


# ---------------------------------------------------------------------------
# Reversible 5/3 synthesis (Annex F)
# ---------------------------------------------------------------------------

def _sr1d_53(low, high, i0, i1):
    """1-D reversible synthesis along axis 0 into positions [i0, i1);
    even global indices are lowpass. ``low``/``high`` may carry
    trailing batch axes (whole rows/columns synthesize at once)."""
    n = i1 - i0
    trail = low.shape[1:] if low.ndim > 1 else \
        (high.shape[1:] if high.ndim > 1 else ())
    if n == 1:
        if i0 % 2 == 0:
            return low.astype(np.int64, copy=True)
        return (np.asarray(high, np.int64) >> 1).copy()
    x = np.zeros((n,) + trail, np.int64)
    p = i0 % 2
    x[p::2] = low                # even global indices (local p)
    x[1 - p::2] = high           # odd global indices

    def _extend(arr):
        # whole-sample symmetric extension by 2 on each side
        ext = np.empty((n + 4,) + trail, np.int64)
        ext[2:-2] = arr
        ext[1] = arr[1] if n > 1 else arr[0]
        ext[0] = arr[2] if n > 2 else arr[0]
        ext[-2] = arr[-2] if n > 1 else arr[-1]
        ext[-1] = arr[-3] if n > 2 else arr[-1]
        return ext

    u = np.arange(i0, i1)
    even = (u % 2 == 0)
    # step 1: X(2n) = Y(2n) - floor((Y(2n-1) + Y(2n+1) + 2) / 4)
    ext = _extend(x)
    upd = x.copy()
    upd[even] = x[even] - ((ext[1:-3][even] + ext[3:-1][even] + 2)
                           >> 2)
    # step 2: X(2n+1) = Y(2n+1) + floor((X(2n) + X(2n+2)) / 2), with
    # the extension reflecting the UPDATED even samples
    ext = _extend(upd)
    odd = ~even
    upd[odd] = x[odd] + ((ext[1:-3][odd] + ext[3:-1][odd]) >> 1)
    return upd


def _synthesize_53(ll, hl, lh, hh, x0, y0, x1, y1):
    """One 2-D reversible synthesis level: (LL, HL, LH, HH) ->
    resolution rectangle [x0, x1) x [y0, y1). Rows synthesize first
    (HOR_SR), then columns (VER_SR) — Annex F 2D_SR order, verified
    bit-exact against OpenJPEG."""
    h = y1 - y0
    w = x1 - x0
    ex = x0 % 2
    ey = y0 % 2
    # interleave: rows at even global v hold (LL | HL), odd (LH | HH);
    # columns at even global u hold (LL | LH), odd (HL | HH)
    a = np.zeros((h, w), np.int64)
    rs_l = slice(ey, h, 2) if ey else slice(0, h, 2)
    rs_h = slice(0, h, 2) if ey else slice(1, h, 2)
    cs_l = slice(ex, w, 2) if ex else slice(0, w, 2)
    cs_h = slice(0, w, 2) if ex else slice(1, w, 2)
    a[rs_l, cs_l] = ll
    a[rs_l, cs_h] = hl
    a[rs_h, cs_l] = lh
    a[rs_h, cs_h] = hh
    # horizontal synthesis (all rows at once), then vertical
    out = _sr1d_53(a[:, cs_l].T, a[:, cs_h].T, x0, x1).T
    res = _sr1d_53(out[rs_l, :], out[rs_h, :], y0, y1)
    return res


# ---------------------------------------------------------------------------
# Irreversible 9/7 synthesis (Annex F.4.8.2, floating lifting)
# ---------------------------------------------------------------------------

_97_ALPHA = -1.586134342059924
_97_BETA = -0.052980118572961
_97_GAMMA = 0.882911075530934
_97_DELTA = 0.443506852043971
_97_K = 1.230174104914001


def _sr1d_97(low, high, i0, i1):
    """1-D irreversible synthesis along axis 0 into [i0, i1); even
    global indices are lowpass. Mirrors :func:`_sr1d_53`'s structure:
    interleave, then the four lifting steps each on a freshly
    symmetric-extended signal (the intermediates keep the whole-sample
    symmetry, so per-step re-extension is exact)."""
    n = i1 - i0
    trail = low.shape[1:] if low.ndim > 1 else \
        (high.shape[1:] if high.ndim > 1 else ())
    if n == 1:
        # single-sample signal: no lifting AND no K de-scaling — the
        # encoder-side transform of a one-sample signal is the
        # identity (OpenJPEG returns early when sn==1, dn==0), so
        # scaling here would bias every width-1 deep resolution of a
        # narrow tile by ~23% (found as +-1..2-pixel noise across the
        # 16-px edge tiles of a 32x32-tiled image)
        arr = low if i0 % 2 == 0 else high
        return np.asarray(arr, np.float64).copy()
    x = np.zeros((n,) + trail, np.float64)
    p = i0 % 2
    x[p::2] = low
    x[1 - p::2] = high

    def _extend(arr):
        ext = np.empty((n + 4,) + trail, np.float64)
        ext[2:-2] = arr
        ext[1] = arr[1] if n > 1 else arr[0]
        ext[0] = arr[2] if n > 2 else arr[0]
        ext[-2] = arr[-2] if n > 1 else arr[-1]
        ext[-1] = arr[-3] if n > 2 else arr[-1]
        return ext

    u = np.arange(i0, i1)
    even = (u % 2 == 0)
    odd = ~even
    # de-scaling (undo the analysis K): low * K, high / K
    x[even] *= _97_K
    x[odd] /= _97_K
    # four lifting steps, reversing the analysis order
    for coef, on_even in ((_97_DELTA, True), (_97_GAMMA, False),
                          (_97_BETA, True), (_97_ALPHA, False)):
        ext = _extend(x)
        sel = even if on_even else odd
        x[sel] = x[sel] - coef * (ext[1:-3][sel] + ext[3:-1][sel])
    return x


def _synthesize_97(ll, hl, lh, hh, x0, y0, x1, y1):
    """One 2-D irreversible synthesis level (float), same interleave
    and HOR_SR-then-VER_SR order as :func:`_synthesize_53`."""
    h = y1 - y0
    w = x1 - x0
    ex = x0 % 2
    ey = y0 % 2
    a = np.zeros((h, w), np.float64)
    rs_l = slice(ey, h, 2) if ey else slice(0, h, 2)
    rs_h = slice(0, h, 2) if ey else slice(1, h, 2)
    cs_l = slice(ex, w, 2) if ex else slice(0, w, 2)
    cs_h = slice(0, w, 2) if ex else slice(1, w, 2)
    a[rs_l, cs_l] = ll
    a[rs_l, cs_h] = hl
    a[rs_h, cs_l] = lh
    a[rs_h, cs_h] = hh
    out = _sr1d_97(a[:, cs_l].T, a[:, cs_h].T, x0, x1).T
    return _sr1d_97(out[rs_l, :], out[rs_h, :], y0, y1)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _parse_for(buf, reduce):
    """The parsed codestream and ``reduce`` checked against its levels."""
    cs = _parse_markers(bytes(buf))
    reduce = int(reduce)
    nl_min = min(cs.coc.get(c, cs.cod)['nl'] for c in range(cs.ncomp))
    if reduce < 0 or reduce > nl_min:
        raise ValueError(
            'reduce=%d out of range: this codestream has %d '
            'decomposition levels (reduce 0..%d)'
            % (reduce, nl_min, nl_min))
    return cs, reduce


def _tiles(cs):
    """``{tile index: its tile-parts' bodies joined}``."""
    per_tile = {}
    for tidx, body in cs.tile_parts:
        per_tile.setdefault(tidx, []).append(body)
    return {t: b''.join(bodies) for t, bodies in per_tile.items()}


def decode_codestream(buf, reduce=0, t1='native'):
    """Decode a raw JPEG 2000 codestream -> (H, W) or (H, W, C) array.

    ``reduce`` drops that many DWT levels (dyadic pyramid): the output
    covers the same extent at ``ceil(size / 2**reduce)`` samples per
    axis, and Tier-1 never decodes the skipped resolutions' packets —
    a quarter of the work per level for typical content. ``t1`` picks
    the Tier-1 decoder: ``'native'`` (C++) or ``'python'``
    (:class:`_T1Decoder`, the specification; about 100x slower)."""
    cs, reduce = _parse_for(buf, reduce)
    rd = 1 << reduce
    H = _ceil_div(cs.ysiz, rd) - _ceil_div(cs.yosiz, rd)
    W = _ceil_div(cs.xsiz, rd) - _ceil_div(cs.xosiz, rd)
    for c in cs.comps:
        if c['xr'] != 1 or c['yr'] != 1:
            raise Jp2Error('component subsampling is not supported')
    irrev = cs.cod['wavelet'] == 0 \
        or any(coc['wavelet'] == 0 for coc in cs.coc.values())
    pdtype = np.float64 if irrev else np.int64
    planes = [np.zeros((H, W), pdtype) for _ in range(cs.ncomp)]

    for tidx, body in _tiles(cs).items():
        tile, (tx0, ty0, tx1, ty1), comps = _decode_tile(
            cs, tidx, body, reduce=reduce, t1=t1)
        for c, arr in enumerate(comps):
            planes[c][_ceil_div(ty0, rd) - _ceil_div(cs.yosiz, rd):
                      _ceil_div(ty1, rd) - _ceil_div(cs.yosiz, rd),
                      _ceil_div(tx0, rd) - _ceil_div(cs.xosiz, rd):
                      _ceil_div(tx1, rd) - _ceil_div(cs.xosiz, rd)] \
                = arr

    # color transform: reversible RCT with the 5/3 path, floating ICT
    # (YCbCr, T.800 G.1.2) with the 9/7 path
    if cs.cod['mct'] == 1:
        if cs.ncomp < 3:
            raise Jp2Error('MCT with fewer than 3 components')
        y, cb, cr = planes[0], planes[1], planes[2]
        if irrev:
            r = y + 1.402 * cr
            g = y - 0.344136 * cb - 0.714136 * cr
            b = y + 1.772 * cb
        else:
            g = y - ((cb + cr) >> 2)
            r = cr + g
            b = cb + g
        planes[0], planes[1], planes[2] = r, g, b

    out = []
    for c, plane in enumerate(planes):
        prec = cs.comps[c]['prec']
        if irrev:
            plane = np.rint(plane).astype(np.int64)
        if not cs.comps[c]['signed']:
            plane = plane + (1 << (prec - 1))
            plane = np.clip(plane, 0, (1 << prec) - 1)
        else:
            lo = -(1 << (prec - 1))
            plane = np.clip(plane, lo, -lo - 1)
        if prec <= 8:
            dt = np.uint8 if not cs.comps[c]['signed'] else np.int8
        elif prec <= 16:
            dt = np.uint16 if not cs.comps[c]['signed'] else np.int16
        else:
            dt = np.uint32 if not cs.comps[c]['signed'] else np.int32
        out.append(plane.astype(dt))
    if len(out) == 1:
        return out[0]
    return np.stack(out, axis=-1)


def _codestream_of(path_or_bytes):
    """The raw codestream of a .jp2 container or .j2k file (path or
    bytes)."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, 'rb') as f:
            buf = f.read()
    if buf[:4] == b'\xff\x4f\xff\x51':
        return buf
    if buf[4:8] != b'jP  ':
        raise Jp2Error('not a JP2 file (missing signature box)')
    # box walk to the contiguous codestream
    pos = 0
    while pos + 8 <= len(buf):
        (lbox,) = struct.unpack('>I', buf[pos:pos + 4])
        tbox = buf[pos + 4:pos + 8]
        hdr = 8
        if lbox == 1:
            (lbox,) = struct.unpack('>Q', buf[pos + 8:pos + 16])
            hdr = 16
        elif lbox == 0:
            lbox = len(buf) - pos
        if tbox == b'jp2c':
            return buf[pos + hdr:pos + lbox]
        pos += lbox
    raise Jp2Error('no codestream (jp2c box) found')


def decode_jp2(path_or_bytes, reduce=0, t1='native'):
    """Decode a .jp2 container (or raw .j2k codestream) from a path or
    bytes; ``reduce`` selects a dyadic overview and ``t1`` the Tier-1
    decoder (see :func:`decode_codestream`)."""
    return decode_codestream(_codestream_of(path_or_bytes), reduce=reduce,
                             t1=t1)


def codeblock_jobs(path_or_bytes, reduce=0):
    """The Tier-1 work of a file: every code-block that
    :func:`decode_jp2` with this ``reduce`` hands to Tier-1, as
    ``(buf, w, h, orientation, npasses, numbps)`` rows in decode order
    (tile, component, resolution, band, block). Either decoder takes
    them: ``_t1_decode_many(jobs, t1)``."""
    cs, reduce = _parse_for(_codestream_of(path_or_bytes), reduce)
    jobs = []
    for tidx, body in _tiles(cs).items():
        for comp in _tile_codeblocks(cs, tidx, body, reduce)[2]:
            jobs.extend(comp[1])
    return jobs
