"""Count what the port's kernels compile to, from their SASS and ptxas.

    python3 -m gym_copter_tpu_torch.ops.sass [--source X.cu] [--dump DIR]
                                             [--via 0x3760,0x3e80]

Builds `csrc/fused_rollout.cu` (or the given source) with the flags of
`_build`, disassembles the library with cuobjdump and prints one JSON line
per kernel: its template arguments, ptxas's registers, stack frame and
spills, the counts of its main loop (`loop_counts`) and of the loop's
straight path (`straight_path`, through the `--via` addresses).  `--dump`
writes the SASS and the ptxas report there as well.  Needs nvcc and cuobjdump,
i.e. the machine with the card; the parsers below run anywhere.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import tempfile
from pathlib import Path

_FUNC = re.compile(r'^\s*Function\s*:\s*(\S+)')
_INSN = re.compile(r'^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;')
_TARGET = re.compile(r'0x([0-9a-f]+)\s*$')
_PTXAS_FUNC = re.compile(r"Compiling entry function '(\S+)'|"
                         r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill '
                          r'stores, (\d+) bytes spill loads')
_PTXAS_REGS = re.compile(r'Used (\d+) registers')
_TEMPLATE = re.compile(r'fused_rollout_kernelILi(\d+)ELi(\d+)ELi(\d+)EE')


def parse_sass(text: str) -> dict:
    """cuobjdump -sass text -> {function name: [(address, instruction)]},
    each instruction as printed, without its ';'."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(insn: str) -> str:
    """The opcode of one instruction, predicate and modifiers dropped:
    '@!P0 BRA.U 0x3b0' -> 'BRA'."""
    words = insn.split()
    if words and words[0].startswith('@'):
        words = words[1:]
    return words[0].split('.')[0] if words else ''


def _target(insn: str):
    m = _TARGET.search(insn)
    return int(m.group(1), 16) if m else None


def loop_counts(insns) -> dict:
    """Counts over the kernel's main loop, the span from the lowest target
    of a backward branch to the last branch that jumps back to it (the T
    loop of the rollout kernel; inner loops, such as sinf's slow range
    reduction, lie inside it).  Code placed out of line, after the
    kernel's EXIT, is not in the span: `function` gives the same counts
    over the whole kernel."""
    back = [(a, _target(i)) for a, i in insns
            if opcode(i) == 'BRA' and _target(i) is not None
            and _target(i) <= a]
    out = {'function': _counts(insns)}
    if not back:
        out['loop'] = None
        return out
    head = min(t for _, t in back)
    tail = max(a for a, t in back if t == head)
    out['loop'] = _counts([(a, i) for a, i in insns if head <= a <= tail])
    out['loop']['span'] = [hex(head), hex(tail)]
    out['loop']['inner_loops'] = sum(1 for a, t in back
                                     if head < t and a <= tail)
    return out


def _predicated(insn: str) -> bool:
    return insn.startswith('@') and not insn.startswith('@PT ')


def straight_path(insns, via=()) -> dict:
    """The shortest way through one iteration of the main loop: from its
    head to its back edge, never taking a backward branch (an inner loop
    runs once) and avoiding, before anything else, instructions that leave
    the fast path (CALL of a slow-path subroutine, LDL/STL of sinf's slow
    range reduction).  Every uniform or data-dependent branch takes its
    cheaper side, so for a kernel specialised to one task this is the step
    the common case runs; `via` lists addresses the path must pass (to
    pick one task's arm in a kernel that switches at run time).  Returns
    the path's counts, with 'slow' the slow-path instructions it could not
    avoid."""
    span = loop_counts(insns)['loop']
    if span is None:
        return None
    head, tail = (int(a, 16) for a in span['span'])
    body = [(a, i) for a, i in insns if head <= a <= tail]
    index = {a: k for k, (a, _) in enumerate(body)}
    end = len(body)

    def successors(k):
        a, insn = body[k]
        op = opcode(insn)
        if k == end - 1:
            return [end]
        if op in ('EXIT', 'RET') and not _predicated(insn):
            return []
        nxt = [] if op == 'BRA' and not _predicated(insn) else [k + 1]
        t = _target(insn) if op == 'BRA' else None
        if t is not None and t > a and t in index:
            nxt.append(index[t])
        return nxt

    def cost(k):
        op = opcode(body[k][1])
        return (int(op in ('CALL', 'LDL', 'STL')), int(op != 'NOP'))

    def shortest(src, dst):
        # forward edges only, so one pass from the back in address order
        inf = (float('inf'), float('inf'))
        best, choice = {dst: (0, 0)}, {}
        for k in range(dst - 1, src - 1, -1):
            options = [(best.get(s, inf), s) for s in successors(k)
                       if s <= dst]
            if not options:
                best[k] = inf
                continue
            (p, n), s = min(options)
            c = cost(k)
            best[k] = (p + c[0], n + c[1])
            choice[k] = s
        path, k = [], src
        while k != dst:
            if best.get(k, (float('inf'),))[0] == float('inf'):
                to = hex(body[dst][0]) if dst < end else 'the back edge'
                raise ValueError(f'no path from {hex(body[src][0])} to {to}')
            path.append(k)
            k = choice[k]
        return path

    stops = [0] + [index[v] for v in via] + [end]
    path = []
    for src, dst in zip(stops, stops[1:]):
        path += shortest(src, dst)
    out = _counts([body[k] for k in path])
    out['slow'] = sum(cost(k)[0] for k in path)
    return out


def _counts(insns) -> dict:
    ops = [opcode(i) for _, i in insns]
    return {'instructions': sum(1 for o in ops if o != 'NOP'),
            'BRA': ops.count('BRA'), 'CALL': ops.count('CALL'),
            'LDL': ops.count('LDL'), 'STL': ops.count('STL'),
            'SHFL': ops.count('SHFL'), 'MUFU': ops.count('MUFU')}


def parse_ptxas(text: str) -> dict:
    """`-Xptxas -v` report -> {function: {'registers', 'stack', 'spill_
    stores', 'spill_loads'}}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _PTXAS_FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1) or m.group(2), {})
        if cur is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            cur['registers'] = int(m.group(1))
    return out


def template_args(name: str):
    """(lanes, kind, termination) of a mangled fused_rollout_kernel
    instantiation, or None for a kernel without them."""
    m = _TEMPLATE.search(name)
    return tuple(int(g) for g in m.groups()) if m else None


def report(library: Path, ptxas: str, via=()):
    """(one dict per kernel of the built library, its SASS text)."""
    from gym_copter_tpu_torch.ops import _build

    sass = subprocess.run([_build.tool('cuobjdump'), '-sass', str(library)],
                          check=True, capture_output=True, text=True).stdout
    regs = parse_ptxas(ptxas)
    rows = []
    for name, insns in parse_sass(sass).items():
        rows.append({'kernel': name, 'template': template_args(name),
                     **regs.get(name, {}), **loop_counts(insns),
                     'straight': straight_path(insns, via)})
    return rows, sass


def main(argv=None):
    from gym_copter_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--source', type=Path,
                    default=_build.CSRC / 'fused_rollout.cu')
    ap.add_argument('--dump', type=Path, default=None)
    ap.add_argument('--via', default='',
                    help='comma-separated hex addresses the straight path '
                         'must pass (see straight_path)')
    args = ap.parse_args(argv)
    via = tuple(int(a, 16) for a in args.via.split(',') if a)
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / 'lib.so'
        ptxas = _build.compile_source(args.source, lib)
        rows, sass = report(lib, ptxas, via)
    if args.dump is not None:
        args.dump.mkdir(parents=True, exist_ok=True)
        (args.dump / 'kernel.sass').write_text(sass)
        (args.dump / 'ptxas.txt').write_text(ptxas)
    for row in rows:
        print(json.dumps(row))


if __name__ == '__main__':
    main()
