"""Build the package's C++ sources into C-ABI shared libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
``lesionvae_tpu_torch/_build/lib<name>_<hash>.so`` at first use and is loaded
with ``ctypes``.  The file name carries a hash of the source, so an edited
kernel is rebuilt and a stale library is never loaded.  Nothing here runs at
import time: the CPU tests import every module on hosts without ``nvcc``.
The host sources (``csrc/<name>.cpp``, ``HOST_SOURCES``) build the same way
with the host's C++ compiler, their hash taking the machine's architecture
too; ``load_host`` gives None where they cannot be built.

``sass(name)`` disassembles a built library with the toolkit's ``cuobjdump``
and ``inner_loops(text, unit)`` counts, per kernel function, the instructions
of its hottest loop by class: what the card issues per unit of work, read
from the machine code where no hardware profiler is at hand.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..utils.logging import get_logger

log = get_logger("cuda_build")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: every source of csrc/, as ``build`` takes them: what a run on the card
#: builds up front (chip_smoke.py)
SOURCES = ("radius", "resident_adam", "sr_adam", "geometry", "masked_bn", "adam", "conv1d")
# flags of one source beyond NVCC_FLAGS.  geometry, masked_bn, adam: no
# contraction of a product and a sum into one FMA, so that every operation
# rounds once, as the plain PyTorch version's separate kernels round
# (conv1d contracts: it is held to its plain version, cuBLAS's products,
# within a tolerance, as FMA-built products are)
EXTRA_FLAGS = {"geometry": ["--fmad=false"], "masked_bn": ["--fmad=false"],
               "adam": ["--fmad=false"]}
#: the host sources of csrc/ (``<name>.cpp``): the fleet's initial-weight
#: draws (``train.batched.draw_init``), built with no FMA contraction
HOST_SOURCES = ("init_draws",)
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off"]


def flags(name: str) -> List[str]:
    if name in HOST_SOURCES:
        return HOST_FLAGS
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _source(name: str) -> Path:
    return CSRC / f"{name}.{'cpp' if name in HOST_SOURCES else 'cu'}"


def _cxx() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on the PATH")
    return cxx


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "package's kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """The library's path; its name carries a hash of the source and flags
    (and of the machine's architecture for a host source)."""
    key = _source(name).read_bytes() + " ".join(flags(name)).encode()
    if name in HOST_SOURCES:
        key += platform.machine().encode()
    digest = hashlib.sha256(key).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every library of ``names`` not yet built, one compiler
    (``nvcc``, or the host's for a host source) per source, all started
    together.  Returns the wall seconds per name built; raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    compilers = {n: _cxx() if n in HOST_SOURCES else _nvcc() for n in todo}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compilers[name], *flags(name), "-o", str(tmp), str(_source(name))]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{Path(compilers[name]).name} {_source(name).name} failed "
                          f"({proc.returncode}):\n{output}")
            continue
        os.replace(tmp, library_path(name))
        log.info("built %s in %.1fs\n%s", library_path(name).name,
                 seconds[name], output.strip())
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> Optional[ctypes.CDLL]:
    """The library of the host source ``csrc/<name>.cpp``, built on first
    use; None, with a log line saying why, on a host that cannot build or
    load it."""
    try:
        return load(name)
    except (RuntimeError, OSError) as e:
        log.warning("host library %s unavailable: %s", name, e)
        return None


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches`` when
    it runs now, in ``wrapper.captured`` when the current stream is
    capturing a CUDA graph; the graph then adds it to ``launches`` at every
    replay (``train.program.EpochGraph``)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


class Count:
    """A count of launches of one kind that no wrapper counts alone, kept
    in ``counts[key]`` and counted as a wrapper's launches are
    (``count_launch``; a graph that recorded one adds it at every replay)."""

    def __init__(self, counts: dict, key: str):
        self.counts, self.key, self.captured = counts, key, 0

    @property
    def launches(self) -> int:
        return self.counts[self.key]

    @launches.setter
    def launches(self, n: int) -> None:
        self.counts[self.key] = n


def sass(name: str) -> str:
    """The machine code (SASS) of the library of ``csrc/<name>.cu``, built
    on first use, as ``cuobjdump -sass`` prints it."""
    build([name])
    cuobjdump = str(Path(_nvcc()).with_name("cuobjdump"))
    return subprocess.run([cuobjdump, "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


# instruction classes of a Hopper SASS listing, by opcode stem
SASS_CLASSES = ("fp32", "mufu", "convert", "alu", "shared", "global", "control")
_FP32 = {"FADD", "FMUL", "FFMA"}
_SHARED = {"LDS", "STS", "LDSM", "STSM", "ATOMS"}
_GLOBAL = {"LDG", "STG", "LD", "ST", "LDGSTS", "LDGDEPBAR", "ATOM", "ATOMG",
           "RED", "LDL", "STL", "LDC", "ULDC"}
_CONTROL = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
            "BREAK", "BAR", "WARPSYNC", "YIELD", "NOP", "DEPBAR", "BMOV", "KILL",
            "NANOSLEEP", "ERRBAR", "MEMBAR", "CCTL"}
_INSTRUCTION = re.compile(
    r"^\s*/\*([0-9a-fA-F]{4,})\*/\s+\{?\s*(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_]*)"
    r"((?:\.[A-Za-z0-9_]+)*)\s*([^;]*);")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")


def sass_class(opcode: str) -> str:
    """The class of one opcode stem (``FFMA``, ``MUFU``, ``F2FP``, ...):
    fp32 = FADD/FMUL/FFMA, mufu = the special-function unit, convert =
    F2F*/F2FP*/I2F*/F2I*, shared and global = loads, stores and atomics,
    control = branches, calls, barriers; alu = every other instruction
    (integer, logic, moves, FMNMX, FCHK, FSETP, ...)."""
    if opcode in _FP32:
        return "fp32"
    if opcode == "MUFU":
        return "mufu"
    if opcode.startswith(("F2F", "I2F", "F2I", "I2I", "FRND")):
        return "convert"
    if opcode in _SHARED:
        return "shared"
    if opcode in _GLOBAL:
        return "global"
    if opcode in _CONTROL:
        return "control"
    return "alu"


def sass_functions(text: str) -> Dict[str, List[tuple]]:
    """``cuobjdump -sass`` text -> {function: [(address, opcode stem, full
    opcode with modifiers, operands), ...]} in listing order."""
    functions: Dict[str, List[tuple]] = {}
    current = None
    for line in text.splitlines():
        f = _FUNCTION.match(line)
        if f:
            current = functions.setdefault(f.group(1), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2),
                            m.group(2) + m.group(3), m.group(4).strip()))
    return functions


def inner_loops(text: str, unit: str) -> Dict[str, dict]:
    """Per kernel function of a SASS listing, the instruction counts of its
    hottest loop.  ``unit`` is a regular expression on the full opcode
    (``MUFU\\.RSQ``, ``FMNMX``) of the instruction that occurs once per unit
    of work (an element-step, a point-direction pair).  A loop is the span
    from a backward branch's target to the branch; the hottest is the
    innermost loop (one that holds no other) with the most units, or the
    whole function when no loop holds one.  Returns {function: {"units",
    "instructions", "per_unit": {class: count / units, "total": ...},
    "counts": {class: count}, "opcodes": {full opcode: count}, "span":
    [first address, last address], "loop": bool}}."""
    unit_re = re.compile(unit)
    out = {}
    for name, code in sass_functions(text).items():
        spans = []
        for addr, op, _full, operands in code:
            target = re.findall(r"0x[0-9a-fA-F]+", operands)
            if op == "BRA" and target and int(target[-1], 16) <= addr:
                spans.append((int(target[-1], 16), addr))
        innermost = [s for s in spans
                     if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                                for o in spans)]

        def body(span):
            return [i for i in code if span[0] <= i[0] <= span[1]]

        def units(instructions):
            return sum(1 for i in instructions if unit_re.search(i[2]))

        best = max(innermost, key=lambda s: units(body(s)), default=None)
        loop = best is not None and units(body(best)) > 0
        instructions = body(best) if loop else code
        n = units(instructions)
        counts = {c: 0 for c in SASS_CLASSES}
        opcodes: Dict[str, int] = {}
        for _addr, op, full, _operands in instructions:
            counts[sass_class(op)] += 1
            opcodes[full] = opcodes.get(full, 0) + 1
        per_unit = {c: v / n for c, v in counts.items()} if n else {}
        if n:
            per_unit["total"] = len(instructions) / n
        out[name] = {"units": n, "instructions": len(instructions),
                     "per_unit": per_unit, "counts": counts,
                     "opcodes": dict(sorted(opcodes.items())),
                     "span": [instructions[0][0], instructions[-1][0]]
                     if instructions else [0, 0], "loop": loop}
    return out
