"""The least time of each launch of the port's kernels, for
`kernels_roofline`.

Each launch's bytes are counted from its arguments as the kernel table of
PERF.md counts them: every input read once and every output written
once, from the shapes and, where the work depends on the data, from the
data of the launch (K5 adds only the nonzero deltas of live tiles). The
least time is the larger of the bytes over the card's bandwidth and the
operations over its float32 rate. The count is of the work, whichever
kernel does it.

Which wrapper's launches are counted, and from which of its arguments, is
data: `benchmark/kernel_counts/<wrapper>.py` names the kernels the wrapper
launches (`KERNELS`) and counts a launch from its arguments by parameter
name (`count(args)`). A later kernel is counted by a new file there.

`Recorder` wraps those wrappers of the port's ops/kernels.py while a
traced window runs, and reads the port's own launch counter
(`kernels.launches`) around each call, so that a call that launched
nothing adds nothing. The share is read only where the trace and the
counts agree: every port kernel in the trace belongs to a counted
wrapper, every launch the port counted has a count, and each wrapper's
launches and its kernels' spans are as many. Where they are not, there is
no reading, and the report says why.
"""

from __future__ import annotations

import glob
import importlib.util
import inspect
import os
import re

HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM, data sheet
F32_FLOPS = 67e12              # float32 outside the tensor cores

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:@[^\n]*\n)*def\s+(\w+)")


def k1_bytes(R: int, S: int, maxr: int, keys_only: bool) -> int:
    """K1 dda_job_stream: reads origin, point, start, end (3 floats each),
    weight and validity per job; writes per (step, job) the key, local
    index, w, w*sdf, colour gate, validity and run index (25 bytes), and
    the (MAXR, R) run keys. Keys only: start, end and validity in, key and
    validity out."""
    if keys_only:
        return 25 * R + 5 * S * R
    return 53 * R + 25 * S * R + 4 * maxr * R


def k1_flops(R: int, S: int) -> int:
    """About 40 float operations a step: the walk, the signed distance,
    the weight's drop-off."""
    return 40 * S * R


def k6_bytes(R: int, S: int, maxr: int) -> int:
    """K6 slot_resolve_stream: reads the run keys and run indices, the
    local index, w, w*sdf, colour gate (4 bytes each a step) and validity,
    the job labels and flags; writes k2, w, w*sdf+trunc*w, count, key (4
    bytes each a step), validity, and the run slots. The camera cube's
    cells are not counted (what is read of it depends on the walk)."""
    return (4 * maxr * R + 21 * S * R + 5 * R
            + 21 * S * R + 4 * maxr * R)


def h1_bytes(n_keys: int) -> int:
    """H1 hash_lookup: each key read and its slot written, and one
    8-byte table position probed a key at the least."""
    return 16 * n_keys


def h2_bytes(table_size: int, capacity: int, n_keys: int) -> int:
    """H2 hash_insert: the table's key and slot words and the block
    coordinates read and written once, the keys and flags read."""
    return 2 * 8 * table_size + 2 * 12 * capacity + 5 * n_keys


def k5_bytes(live_rows: int, V3: int, planes: int, colour: bool,
             nz_w: int, nz_cnt: int, nz_votes: int) -> int:
    """K5 block_rmw_add: the live tiles' delta rows read (w, w*sdf, count
    and the vote planes, and colour when blended); the grid words of the
    nonzero deltas read and written (wsum and wsdf where w is nonzero,
    sem_count where the count is, one log-odds word a vote)."""
    rows = live_rows * V3 * 4 * (3 + planes + (3 if colour else 0))
    return rows + 2 * 4 * (2 * nz_w + nz_cnt + nz_votes)


def least_s(nbytes: int, flops: int = 0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def load_counts(directory: str) -> dict:
    """wrapper name -> its count module, one `<wrapper>.py` a wrapper."""
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(
            "kbench_count_" + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def port_kernel_names(kernels) -> set:
    """The kernels of the port's sources: every `__global__` function of
    its csrc/ and every `@triton.jit` function of its Python modules."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))
    names = set()
    for path in glob.glob(os.path.join(pkg, "csrc", "**", "*.cu"),
                          recursive=True):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    for path in glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True):
        with open(path) as f:
            src = f.read()
        if "triton" in src:
            names.update(_TRITON.findall(src))
    return names


def kernel_base(event_name: str) -> str:
    """The function name of a profiler kernel event: 'void
    (anonymous namespace)::hash_insert_kernel_smem<512, 1>(int const*)'
    -> 'hash_insert_kernel_smem'."""
    s = event_name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    m = re.match(r"[\w:]+", s)
    return m.group(0).split("::")[-1] if m else ""


class Recorder:
    """Wraps the counted wrappers of `kernels` (the port's ops/kernels.py)
    while active. `launches` holds (wrapper name, least-time thunk or None)
    for each kernel launch the port's counter saw; `problems` what kept a
    launch from being counted."""

    def __init__(self, kernels, counts: dict):
        self.kernels = kernels
        self.counts = counts
        self.launches = []
        self.problems = []
        self._saved = {}
        self._before = {}

    def __enter__(self):
        k = self.kernels
        self._before = dict(getattr(k, "launches", {}))
        for name, mod in self.counts.items():
            real = getattr(k, name, None)
            if real is None:
                continue
            self._saved[name] = real
            setattr(k, name, self._wrap(name, real, mod))
        return self

    def __exit__(self, *exc):
        for name, real in self._saved.items():
            setattr(self.kernels, name, real)
        return False

    def port_launches(self) -> dict:
        """Launches the port's own counter saw while active, by wrapper."""
        now = getattr(self.kernels, "launches", {})
        return {n: v - self._before.get(n, 0) for n, v in now.items()
                if v - self._before.get(n, 0)}

    def _wrap(self, name, real, mod):
        sig = inspect.signature(real)
        counter = getattr(self.kernels, "launches", None)

        def rec(*a, **kw):
            n0 = counter.get(name) if counter is not None else None
            out = real(*a, **kw)
            n = (counter.get(name) - n0 if n0 is not None
                 and counter.get(name) is not None else None)
            if n is None:
                self.problems.append(f"{name}: the port counts no launches")
                self.launches.append((name, None))
                return out
            if n == 0:
                return out
            try:
                ba = sig.bind(*a, **kw)
                ba.apply_defaults()
                thunk = mod.count(dict(ba.arguments))
            except Exception as e:  # noqa: BLE001 - reported, no reading
                self.problems.append(f"{name}: {type(e).__name__}: {e}")
                thunk = None
            self.launches.extend([(name, thunk)] * n)
            return out
        return rec


def roofline_share(launches, kernel_events, port_names, counts,
                   port_launches, problems=()):
    """(Sum of the launches' least times over the sum of their kernels'
    device times in percent, or None; a report of launches and spans by
    wrapper and of what kept a reading back)."""
    report = {"problems": list(problems), "wrappers": {}}
    owner = {}
    for name, mod in counts.items():
        for kname in mod.KERNELS:
            owner[kname] = name
    by = {}
    for e in kernel_events:
        base = kernel_base(e.name)
        if base in owner:
            by.setdefault(owner[base], []).append(e)
        elif base in port_names:
            report["problems"].append(
                f"port kernel {base} in the trace has no count")
    for name, n in port_launches.items():
        if name not in counts:
            report["problems"].append(
                f"{n} launches of {name}, which has no count")
    least = dev = 0.0
    for name in sorted(set(by) | {n for n, _ in launches}):
        mine = [t for n, t in launches if n == name]
        spans = by.get(name, [])
        report["wrappers"][name] = {"launches": len(mine),
                                    "spans": len(spans)}
        if len(mine) != len(spans):
            report["problems"].append(
                f"{name}: {len(mine)} launches, {len(spans)} spans")
            continue
        if any(t is None for t in mine):
            continue
        least += sum(t() for t in mine)
        dev += sum(e.time_range.elapsed_us() for e in spans) / 1e6
    if report["problems"] or dev <= 0:
        return None, report
    return 100.0 * least / dev, report
