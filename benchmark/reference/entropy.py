"""The entropy layer of PFV v2.1.1 (FORMAT.md "Entropy layer"; pfv-rs
`rle.rs`, `huffman.rs`, `enc.rs:237-481`): per-block RLE of 256 zigzag
coefficients into (zero run <= 15, coefficient size, coefficient), one
16-symbol Huffman tree per frame from the normalised histogram (quirk Q2),
LSB-first bit fields. `frame_payload` writes a payload with vectorised
PyTorch on any device; `read_payload` is a slow scalar reader, for tests
at tiny sizes.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_table(counts) -> list[int]:
    mx = max(counts)
    return [max(1, c * 255 // mx) if c > 0 else 0 for c in counts]


class _Node:
    __slots__ = ("freq", "ch", "left", "right")

    def __init__(self, freq, ch=None, left=None, right=None):
        self.freq, self.ch, self.left, self.right = freq, ch, left, right


def huffman(table):
    """(codes {symbol: (bits, length)}, root): symbols with a nonzero
    frequency in ascending order, stable-sorted by descending frequency;
    the two lowest popped (left, then right) and merged before the first
    strictly smaller frequency; left 0, right 1, accumulated LSB-first."""
    p = [_Node(f, ch) for ch, f in enumerate(table) if f > 0]
    p.sort(key=lambda n: -n.freq)
    while len(p) > 1:
        a, b = p.pop(), p.pop()
        c = _Node(a.freq + b.freq, None, a, b)
        ins = next((i for i, n in enumerate(p) if c.freq > n.freq), len(p))
        p.insert(ins, c)
    codes: dict[int, tuple[int, int]] = {}
    stack = [(p[0], 0, 0)] if p else []
    while stack:
        node, val, length = stack.pop()
        if node.ch is not None:
            codes[node.ch] = (val, length)
            continue
        stack.append((node.left, val, length + 1))
        stack.append((node.right, val | (1 << length), length + 1))
    return codes, (p[0] if p else None)


def _bitlength(a: torch.Tensor) -> torch.Tensor:
    return sum((a >= (1 << b)).long() for b in range(16))


def _rle(coeffs: torch.Tensor):
    """Coded blocks (m, 256) -> the RLE of each block as groups in stream
    order: (fillers, final run symbol, final size symbol, final value) per
    group. A group is a nonzero coefficient (its (15, 0) fillers, then
    (run, size, value)) or a block's trailing zeros ((15, 0) fillers, then
    (run, 0)). Every block flushes its trailing run (quirk Q6)."""
    dev = coeffs.device
    m = coeffs.shape[0]
    blk, pos = torch.nonzero(coeffs, as_tuple=True)
    val = coeffs[blk, pos].long()
    first = torch.ones_like(blk, dtype=torch.bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = torch.where(first, torch.full_like(pos, -1), torch.roll(pos, 1))
    run = pos - prev - 1
    nz_fill = torch.where(run > 0, torch.div(run - 1, 15, rounding_mode="floor"), 0)
    last = torch.full((m,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, blk, pos, "amax")
    tail = 255 - last
    t_fill = torch.div(tail + 14, 15, rounding_mode="floor") - 1
    has_tail = tail > 0
    tb = torch.nonzero(has_tail).squeeze(1)
    keys = torch.cat([blk * 257 + pos, tb * 257 + 256])
    order = torch.argsort(keys)
    fillers = torch.cat([nz_fill, t_fill[tb]])[order]
    run_sym = torch.cat([run - 15 * nz_fill, tail[tb] - 15 * t_fill[tb]])[order]
    value = torch.cat([val, torch.zeros_like(tb)])[order]
    size = torch.where(value != 0, _bitlength(value.abs()) + 1, 0)
    return fillers, run_sym, size, value


def _pack(vals: torch.Tensor, lens: torch.Tensor) -> bytes:
    """LSB-first bit fields (value, length) -> bytes, byte-aligned with
    zero bits."""
    dev = vals.device
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if lens.numel() else 0
    nbytes = (total + 7) // 8
    if total == 0:
        return b""
    field = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens)
    j = torch.arange(total, device=dev) - (ends - lens)[field]
    bits = torch.zeros(nbytes * 8, dtype=torch.long, device=dev)
    bits[:total] = (vals[field] >> j) & 1
    out = (bits.view(-1, 8) << torch.arange(8, device=dev)).sum(1)
    return out.to(torch.uint8).cpu().numpy().tobytes()


def frame_payload(coeffs: torch.Tensor, qidx, motion=None) -> bytes:
    """One frame's payload. I-frame (motion None): every block of (nb, 256)
    `coeffs` coded. P-frame: motion = (mvx, mvy, hc) (nb,) each; block
    headers (has_mvec, has_coeff, then mx and my as signed 7-bit fields
    where the vector is not zero), then the coded blocks' coefficients."""
    dev = coeffs.device
    coded = coeffs if motion is None else coeffs[motion[2].bool()]
    fillers, run_sym, size, value = _rle(coded.long())
    counts = (torch.bincount(run_sym, minlength=16) + torch.bincount(size, minlength=16))
    counts[15] += fillers.sum()
    counts[0] += fillers.sum()
    table = normalize_table(counts.tolist())
    codes, _ = huffman(table)
    cv = torch.tensor([codes.get(s, (0, 0))[0] for s in range(16)], device=dev)
    cl = torch.tensor([codes.get(s, (0, 0))[1] for s in range(16)], device=dev)

    # coefficient fields: each group's fillers, then its final field
    fill_val = cv[15] | (cv[0] << cl[15])
    fill_len = cl[15] + cl[0]
    mag = torch.where(size > 0, value & ((1 << (size - 1).clamp(min=0)) - 1), 0)
    vbits = mag | ((value < 0).long() << (size - 1).clamp(min=0))
    fin_val = cv[run_sym] | (cv[size] << cl[run_sym]) | (vbits << (cl[run_sym] + cl[size]))
    fin_len = cl[run_sym] + cl[size] + size
    per = fillers + 1
    group = torch.repeat_interleave(torch.arange(per.numel(), device=dev), per)
    k = torch.arange(group.numel(), device=dev) - (torch.cumsum(per, 0) - per)[group]
    is_fill = k < fillers[group]
    c_val = torch.where(is_fill, fill_val, fin_val[group])
    c_len = torch.where(is_fill, fill_len, fin_len[group])

    head = torch.tensor(list(table) + [int(q) for q in qidx], device=dev)
    vals, lens = [head], [torch.full_like(head, 8)]
    if motion is not None:
        mvx, mvy, hc = (t.long() for t in motion)
        has_mv = (mvx != 0) | (mvy != 0)
        s7 = lambda v: (v & 63) | ((v < 0).long() << 6)  # noqa: E731
        vals.append(has_mv.long() | (hc << 1) | (s7(mvx) << 2) | (s7(mvy) << 9))
        lens.append(2 + 14 * has_mv.long())
    vals.append(c_val)
    lens.append(c_len)
    return _pack(torch.cat(vals), torch.cat(lens))


class BitReader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            p = self.pos + i
            v |= ((self.data[p >> 3] >> (p & 7)) & 1) << i
        self.pos += n
        return v

    def read_signed(self, n: int) -> int:
        u = self.read(n - 1)
        return u - (1 << (n - 1)) if self.read(1) else u

    def symbol(self, root) -> int:
        node = root
        while node.ch is None:
            node = node.right if self.read(1) else node.left
        return node.ch


def _read_coeffs(br: BitReader, root, total: int) -> list[int]:
    out, i = [0] * total, 0
    while i < total:
        i += br.symbol(root)
        n = br.symbol(root)
        if n > 0:
            out[i] = br.read_signed(n)
            i += 1
    return out


def read_payload(payload: bytes, nb: int, ptype: int):
    """Slow scalar reader -> (coeffs (nb, 256) int64, mvx, mvy, hc (nb,),
    qidx (3,)) as numpy arrays."""
    br = BitReader(payload)
    table = [br.read(8) for _ in range(16)]
    _, root = huffman(table)
    qidx = np.array([br.read(8) for _ in range(3)])
    mvx, mvy = np.zeros(nb, np.int64), np.zeros(nb, np.int64)
    hc = np.ones(nb, np.int64)
    if ptype == 1:
        coeffs = np.array(_read_coeffs(br, root, nb * 256)).reshape(nb, 256)
        return coeffs, mvx, mvy, hc, qidx
    for b in range(nb):
        has_mv, hc[b] = br.read(1), br.read(1)
        if has_mv:
            mvx[b], mvy[b] = br.read_signed(7), br.read_signed(7)
    coeffs = np.zeros((nb, 256), np.int64)
    for b in np.flatnonzero(hc):
        coeffs[b] = _read_coeffs(br, root, 256)
    return coeffs, mvx, mvy, hc, qidx
