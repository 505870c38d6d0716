"""Print a saved model/program file in human-readable form (reference
python/paddle/utils/show_pb.py, which printed the ModelConfig/
ParameterConfig protobufs). Here model programs ship as the JSON schema
(plain or gzipped), so this pretty-prints block/op/var structure."""

from __future__ import annotations

import gzip
import json
import sys

__all__ = ["read_program", "show_program", "main"]


def read_program(path):
    """Load a serialized program (JSON, optionally gzipped) as a dict."""
    with open(path, "rb") as f:
        head = f.read(2)
    opener = gzip.open if head == b"\x1f\x8b" else open
    with opener(path, "rb") as f:
        return json.loads(f.read().decode("utf-8"))


def show_program(d, out=None):
    out = out or sys.stdout  # read at call time: a caller may redirect it
    out.write("format: %s v%s\n" % (d.get("format"), d.get("version")))
    for blk in d.get("blocks", []):
        out.write(
            "block %d (parent %s): %d vars, %d ops\n"
            % (
                blk["idx"], blk["parent_idx"],
                len(blk["vars"]), len(blk["ops"]),
            )
        )
        for v in blk["vars"]:
            out.write(
                "  var %s: shape=%s dtype=%s%s\n"
                % (
                    v["name"], v.get("shape"), v.get("dtype"),
                    " [param]" if v.get("is_parameter") else "",
                )
            )
        for op in blk["ops"]:
            out.write(
                "  op %s(%s) -> %s\n"
                % (
                    op["type"],
                    ", ".join(
                        "%s=%s" % (k, v) for k, v in sorted(
                            op.get("inputs", {}).items()
                        )
                    ),
                    ", ".join(
                        "%s=%s" % (k, v) for k, v in sorted(
                            op.get("outputs", {}).items()
                        )
                    ),
                )
            )


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        sys.stderr.write("usage: python -m paddle_tpu_torch.utils.show_pb "
                         "<program.json[.gz]>\n")
        return 1
    show_program(read_program(argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
