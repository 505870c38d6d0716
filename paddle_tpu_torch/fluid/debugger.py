"""Program introspection dumps (counterpart of
paddle_tpu/fluid/debugger.py; reference fluid/debuger.py
pprint_program_codes + draw_block_graphviz via fluid/graphviz.py,
net_drawer.py)."""

from __future__ import annotations

from typing import Optional

from .core.program import Program

__all__ = ["pprint_program_codes", "draw_block_graphviz", "program_to_code"]


def program_to_code(program: Program) -> str:
    """Pseudo-code dump of every block (reference debuger.py)."""
    lines = []
    for blk in program.blocks:
        lines.append("// block %d (parent %d)" % (blk.idx, blk.parent_idx))
        for v in blk.vars.values():
            lines.append(
                "var %s : %s%s%s"
                % (
                    v.name,
                    v.dtype,
                    list(v.shape) if v.shape else "[?]",
                    "  // persistable" if v.persistable else "",
                )
            )
        for op in blk.ops:
            ins = ", ".join(
                "%s=%s" % (k, v) for k, v in sorted(op.inputs.items())
            )
            outs = ", ".join(
                "%s" % v for _, v in sorted(op.outputs.items())
            )
            lines.append("%s = %s(%s)" % (outs or "()", op.type, ins))
    return "\n".join(lines)


def pprint_program_codes(program: Program):
    print(program_to_code(program))


def draw_block_graphviz(block, path: Optional[str] = None, name="program"):
    """Emit a graphviz dot description of a block's dataflow (reference
    graphviz.py/net_drawer.py). Returns the dot source; writes it to
    `path` when given (render with `dot -Tpng` externally)."""
    lines = ["digraph %s {" % name, "  rankdir=TB;"]
    esc = lambda s: s.replace('"', "'")
    seen_vars = set()
    for i, op in enumerate(block.ops):
        op_id = "op_%d" % i
        lines.append(
            '  %s [label="%s", shape=box, style=filled, fillcolor=lightblue];'
            % (op_id, esc(op.type))
        )
        for names in op.inputs.values():
            for n in names:
                vid = "var_%s" % abs(hash(n))
                if n not in seen_vars:
                    seen_vars.add(n)
                    lines.append('  %s [label="%s", shape=ellipse];' % (vid, esc(n)))
                lines.append("  %s -> %s;" % (vid, op_id))
        for names in op.outputs.values():
            for n in names:
                vid = "var_%s" % abs(hash(n))
                if n not in seen_vars:
                    seen_vars.add(n)
                    lines.append('  %s [label="%s", shape=ellipse];' % (vid, esc(n)))
                lines.append("  %s -> %s;" % (op_id, vid))
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
