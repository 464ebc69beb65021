"""M-bias SVG/TXT rendering + trimming-threshold suggestion (svg.c).

The strandMeth counters here are numpy arrays of shape [2 reads, 2 states,
L] (meth=state 0, unmeth=state 1) per strand; `l` is the highest used cycle
+ 1. All geometry, axis scaling, the Agresti-Coull 99.9% CI (svg.c:10-27)
and the threshold-suggestion walk (svg.c:240-296) reproduce the C exactly,
including its printf formatting (%f, %4.2f).
"""
from __future__ import annotations

import math
import sys

ABBREVS = ["OT", "OB", "CTOT", "CTOB"]
TITLES = [
    "Original Top", "Original Bottom",
    "Complementary to the Original Top", "Complementary to the Original Bottom",
]
COL1 = "rgb(248,118,109)"
COL2 = "rgb(0,191,196)"


def ci(um: int, m: int, which: int) -> float:
    """Agresti-Coull 99.9% confidence bound (svg.c:10-27)."""
    x = float(m)
    n = float(m + um)
    zz = 10.8275661707
    z = 3.2905267315
    n_dot = n + zz
    p_dot = (1.0 / n_dot) * (x + 0.5 * zz)
    if which:
        rv = p_dot + z * math.sqrt((p_dot / n_dot) * (1 - p_dot))
        return min(rv, 1.0)
    rv = p_dot - z * math.sqrt((p_dot / n_dot) * (1 - p_dot))
    return max(rv, 0.0)


def _f(x: float) -> str:
    return f"{x:.6f}"


class StrandMeth:
    """strandMeth (MethylDackel.h:172-176) with numpy-backed counters."""

    def __init__(self, counters=None, l: int = 0):
        import numpy as np

        if counters is None:
            counters = np.zeros((2, 2, 0), dtype=np.uint64)
        self.c = counters  # [read(0/1), state(0 meth/1 unmeth), cycle]
        self.l = l

    def meth(self, which: int, i: int) -> int:
        return int(self.c[which - 1, 0, i]) if i < self.c.shape[2] else 0

    def unmeth(self, which: int, i: int) -> int:
        return int(self.c[which - 1, 1, i]) if i < self.c.shape[2] else 0


def get_max_y(m: StrandMeth) -> float:
    maximum = 0.0
    for i in range(m.l):
        for r in (1, 2):
            if m.meth(r, i) + m.unmeth(r, i):
                maximum = max(maximum, ci(m.unmeth(r, i), m.meth(r, i), 1))
    maximum += 0.03
    c100 = math.ceil(100 * maximum)
    if 5 * (int(c100) // 5) - int(c100):
        maximum = (1 + int(c100) // 5) * 0.05
    else:
        maximum = (int(c100) // 5) * 0.05
    if maximum > 0.8:
        maximum = 1.0
    assert maximum > 0.0
    return maximum


def get_min_y(m: StrandMeth) -> float:
    minimum = 1.0
    for i in range(m.l):
        for r in (1, 2):
            if m.meth(r, i) + m.unmeth(r, i):
                minimum = min(minimum, ci(m.unmeth(r, i), m.meth(r, i), 0))
    minimum -= 0.03
    minimum = 0.01 * (5 * (int(100 * minimum) // 5))
    if minimum < 0.2:
        minimum = 0.0
    assert minimum < 1.0
    return minimum


def get_min_x(m: StrandMeth, which: int) -> int:
    for i in range(m.l):
        if m.meth(which, i) + m.unmeth(which, i):
            return i
    return m.l


def get_max_x(m: StrandMeth) -> int:
    i = m.l
    while i > 0:
        if m.meth(1, i - 1) + m.unmeth(1, i - 1):
            break
        if m.meth(2, i - 1) + m.unmeth(2, i - 1):
            break
        i -= 1
    if i % 5:
        i += 5 - (i % 5)
    return i


def get_x_ticks(max_x: int):
    """getXTicks (svg.c:110-149) — including its if/else-if chain that only
    ever tries span=10 after 5."""
    max_n = 7
    span = 5
    n = max_x // 5
    if n > max_n:
        span = 10
        n = max_x // span
    return [(i + 1) * span for i in range(n)]


def get_y_ticks(min_y: float, max_y: float):
    span = max_y - min_y
    n = int(1 + math.ceil(span / 0.05))
    if span < 0.05:
        n = 2
    return [0.05 * i + min_y for i in range(n)]


def remap_y(orig: float, min_y: float, max_y: float, buffer: int, dim: int) -> float:
    return buffer + dim - dim * (orig - min_y) / (max_y - min_y)


def remap_x(orig: int, max_x: int, buffer: int, dim: int) -> float:
    return buffer + dim * orig / max_x


def plot_ci(out, min_x, max_x, m: StrandMeth, which, col, buffer, dim, min_y, max_y):
    val = ci(m.unmeth(which, min_x), m.meth(which, min_x), 0)
    out.append(f"<path d=\"M {_f(remap_x(min_x + 1, max_x, buffer, dim))} "
               f"{_f(remap_y(val, min_y, max_y, buffer, dim))}\n")
    for i in range(min_x + 1, m.l + 1):
        if m.meth(which, i) or m.unmeth(which, i):
            val = ci(m.unmeth(which, i), m.meth(which, i), 0)
            out.append(f"  L {_f(remap_x(i + 1, max_x, buffer, dim))} "
                       f"{_f(remap_y(val, min_y, max_y, buffer, dim))}\n")
    for i in range(m.l - 1, -1, -1):
        if m.meth(which, i) or m.unmeth(which, i):
            val = ci(m.unmeth(which, i), m.meth(which, i), 1)
            out.append(f"  L {_f(remap_x(i + 1, max_x, buffer, dim))} "
                       f"{_f(remap_y(val, min_y, max_y, buffer, dim))}\n")
    out.append(f"Z\" fill=\"{col}\" fill-opacity=\"0.2\"/>\n")


def plot_vals(out, min_x, max_x, m: StrandMeth, which, col, buffer, dim, min_y, max_y):
    assert min_x >= 0
    val = m.meth(which, min_x) / (m.meth(which, min_x) + m.unmeth(which, min_x))
    out.append(f"<path d=\"M {_f(remap_x(min_x + 1, max_x, buffer, dim))} "
               f"{_f(remap_y(val, min_y, max_y, buffer, dim))}\n")
    for i in range(min_x + 1, m.l + 1):
        if m.meth(which, i) or m.unmeth(which, i):
            val = m.meth(which, i) / (m.meth(which, i) + m.unmeth(which, i))
            out.append(f"  L {_f(remap_x(i + 1, max_x, buffer, dim))} "
                       f"{_f(remap_y(val, min_y, max_y, buffer, dim))}\n")
    out.append(f"\" stroke=\"{col}\" stroke-width=\"2\" fill-opacity=\"0\"/>\n")


def get_thresholds(m: StrandMeth, which: int):
    """getThresholds (svg.c:240-296): suggested inclusion bounds."""
    total = 0
    middle = m.l // 2
    average = 0.0
    min_ci = 1.0
    max_ci = 0.0
    for i in range(int(0.2 * m.l), int(0.8 * m.l) + 1):
        me, um = m.meth(which, i), m.unmeth(which, i)
        if me or um:
            total += 1
            average += me / (me + um)
            tmp = ci(um, me, 1)
            if min_ci > tmp:
                min_ci = tmp
            tmp = ci(um, me, 0)
            if max_ci < tmp:
                max_ci = tmp
    if total:
        average /= total
    else:
        return 0, 0

    i = middle
    while i >= 0:
        me, um = m.meth(which, i), m.unmeth(which, i)
        if me or um:
            tmp = me / (me + um)
            tmp2 = ci(um, me, 1)
            if tmp2 < average and tmp < min_ci and abs(tmp - average) > 0.05:
                break
            tmp2 = ci(um, me, 0)
            if tmp2 > average and tmp > max_ci and abs(tmp - average) > 0.05:
                break
        i -= 1
    lthresh = i + 2 if i >= 0 else 0

    i = middle + 1
    while i < m.l:
        me, um = m.meth(which, i), m.unmeth(which, i)
        if me or um:
            tmp = me / (me + um)
            tmp2 = ci(um, me, 1)
            if tmp2 < average and tmp < min_ci and abs(tmp - average) > 0.05:
                break
            tmp2 = ci(um, me, 0)
            if tmp2 > average and tmp > max_ci and abs(tmp - average) > 0.05:
                break
        i += 1
    rthresh = i if i < m.l else 0
    return lthresh, rthresh


def make_svgs(opref: str, meths, which: int) -> None:
    """makeSVGs (svg.c:302-437): one SVG per strand with data + stderr
    trimming suggestions."""
    buffer, dim = 80, 500
    already_printing = False
    for i in range(4):
        m = meths[i]
        if not m.l:
            continue
        min_y = get_min_y(m)
        max_y = get_max_y(m)
        min_x1 = get_min_x(m, 1)
        min_x2 = get_min_x(m, 2)
        max_x = get_max_x(m)
        x_ticks = get_x_ticks(max_x)
        y_ticks = get_y_ticks(min_y, max_y)

        out = []
        out.append(f"<svg height=\"{dim + 2 * buffer}\" width=\"{dim + 2 * buffer}\"\n")
        out.append("    xmlns=\"http://www.w3.org/2000/svg\"\n")
        out.append("    xmlns:xlink=\"http://www.w3.org/1999/xlink\"\n")
        out.append("    xmlns:ev=\"http://www.w3.org/2001/xml-events\">\n")
        out.append(f"<title>{TITLES[i]} Strand</title>\n")
        out.append(f"<rect x=\"0\" y=\"0\" width=\"{dim + 2 * buffer}\" "
                   f"height=\"{dim + 2 * buffer}\" fill=\"white\" />\n")
        out.append(f"<text x=\"{buffer + (dim >> 1)}\" y=\"20\" "
                   f"text-anchor=\"middle\">{TITLES[i]} Strand</text>\n")
        out.append(f"<line x1=\"{buffer}\" y1=\"{buffer}\" x2=\"{buffer}\" "
                   f"y2=\"{buffer + dim}\" stroke=\"black\" />\n")
        out.append(f"<line x1=\"{buffer}\" y1=\"{buffer + dim}\" x2=\"{buffer + dim}\" "
                   f"y2=\"{buffer + dim}\" stroke=\"black\" />\n")

        out.append(f"<text x=\"15\" y=\"{buffer + (dim >> 1)}\" "
                   f"transform=\"rotate(270 15, {buffer + (dim >> 1)})\" "
                   f"text-anchor=\"middle\" dominant-baseline=\"text-before-edge\">")
        label_parts = []
        if which & 1:
            label_parts.append("CpG")
        if which & 2:
            label_parts.append("CHG")
        if which & 4:
            label_parts.append("CHH")
        label = "/".join(label_parts)
        if label:
            label += " "
        out.append(f"{label}Methylation %</text>\n")
        out.append(f"<text x=\"{buffer + (dim >> 1)}\" y=\"{buffer + dim + 40}\" "
                   f"text-anchor=\"middle\">Position along mapped read "
                   f"(5'->3' of + strand)</text>\n")
        out.append(f"<line x1=\"{buffer}\" y1=\"{buffer + dim}\" x2=\"{buffer}\" "
                   f"y2=\"{buffer + dim + 5}\" stroke=\"black\" />\n")
        out.append(f"<text x=\"{buffer}\" y=\"{buffer + dim + 20}\" "
                   f"text-anchor=\"middle\">0</text>\n")
        for t in x_ticks:
            x = _f(remap_x(t, max_x, buffer, dim))
            out.append(f"<line x1=\"{x}\" y1=\"{buffer}\" x2=\"{x}\" y2=\"{buffer + dim}\" "
                       f"stroke-dasharray=\"5 5\" stroke=\"grey\" />\n")
            out.append(f"<line x1=\"{x}\" y1=\"{buffer + dim}\" x2=\"{x}\" "
                       f"y2=\"{buffer + dim + 5}\" stroke=\"black\" />\n")
            out.append(f"<text x=\"{x}\" y=\"{buffer + dim + 20}\" "
                       f"text-anchor=\"middle\">{t}</text>\n")
        for t in y_ticks:
            y = _f(remap_y(t, min_y, max_y, buffer, dim))
            out.append(f"<line x1=\"{buffer}\" y1=\"{y}\" x2=\"{buffer - 5}\" y2=\"{y}\" "
                       f"stroke=\"black\" />\n")
            out.append(f"<text x=\"{buffer - 25}\" y=\"{y}\" text-anchor=\"middle\" "
                       f"dominant-baseline=\"middle\">{t:4.2f}</text>\n")

        has_read1 = any(m.meth(1, j) + m.unmeth(1, j) for j in range(m.l))
        has_read2 = any(m.meth(2, j) + m.unmeth(2, j) for j in range(m.l))

        if has_read1:
            plot_ci(out, min_x1, max_x, m, 1, COL1, buffer, dim, min_y, max_y)
        if has_read2:
            plot_ci(out, min_x2, max_x, m, 2, COL2, buffer, dim, min_y, max_y)
        if has_read1:
            plot_vals(out, min_x1, max_x, m, 1, COL1, buffer, dim, min_y, max_y)
        if has_read2:
            plot_vals(out, min_x2, max_x, m, 2, COL2, buffer, dim, min_y, max_y)

        l1, r1 = get_thresholds(m, 1)
        l2, r2 = get_thresholds(m, 2)
        if l1 + l2 + r1 + r2:
            out.append(f"<text x=\"{2 * buffer + dim - 10}\" y=\"{2 * buffer + dim - 10}\" "
                       f"text-anchor=\"end\">--{ABBREVS[i]} {l1},{r1},{l2},{r2}</text>\n")
            for thresh, col in ((l1, COL1), (r1, COL1), (l2, COL2), (r2, COL2)):
                if thresh:
                    x = _f(remap_x(thresh, max_x, buffer, dim))
                    out.append(f"<line x1=\"{x}\" y1=\"{dim + buffer}\" x2=\"{x}\" "
                               f"y2=\"{buffer}\" stroke-dasharray=\"5 1\" stroke=\"{col}\" "
                               f"stroke-width=\"1\" />\n")

        if has_read1:
            out.append(f"<rect x=\"{dim + buffer + 10}\" y=\"{(dim >> 1) + buffer - 20}\" "
                       f"width=\"20\" height=\"20\" fill=\"{COL1}\" />\n")
            out.append(f"<text x=\"{dim + buffer + 35}\" y=\"{(dim >> 1) + buffer - 10}\" "
                       f"text-anchor=\"start\" dominant-baseline=\"middle\">#1</text>\n")
        if has_read2:
            out.append(f"<rect x=\"{dim + buffer + 10}\" y=\"{(dim >> 1) + buffer}\" "
                       f"width=\"20\" height=\"20\" fill=\"{COL2}\" />\n")
            out.append(f"<text x=\"{dim + buffer + 35}\" y=\"{(dim >> 1) + buffer + 10}\" "
                       f"text-anchor=\"start\" dominant-baseline=\"middle\">#2</text>\n")
        out.append("</svg>\n")

        with open(f"{opref}_{ABBREVS[i]}.svg", "w") as fh:
            fh.write("".join(out))

        if not already_printing:
            sys.stderr.write("Suggested inclusion options:")
        sys.stderr.write(f" --{ABBREVS[i]} {l1},{r1},{l2},{r2}")
        already_printing = True
    if already_printing:
        sys.stderr.write("\n")


def make_txt(meths, out=None) -> None:
    """makeTXT (svg.c:439-454): tab-separated dump to stdout, 1-based."""
    out = out or sys.stdout
    out.write("Strand\tRead\tPosition\tnMethylated\tnUnmethylated\n")
    for i in range(4):
        m = meths[i]
        if not m.l:
            continue
        for j in range(m.l):
            if m.meth(1, j) or m.unmeth(1, j):
                out.write(f"{ABBREVS[i]}\t1\t{j + 1}\t{m.meth(1, j)}\t{m.unmeth(1, j)}\n")
            if m.meth(2, j) or m.unmeth(2, j):
                out.write(f"{ABBREVS[i]}\t2\t{j + 1}\t{m.meth(2, j)}\t{m.unmeth(2, j)}\n")
