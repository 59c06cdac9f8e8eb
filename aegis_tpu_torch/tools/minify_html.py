"""HTML minifier for the SPA (reference minify_omega.py).  A copy of
``aegis_tpu/tools/minify_html.py``, held equal to it by
``tests/test_torch_side_tools.py``; the manifest header keeps its text, so
both give the same bytes.

Strips HTML comments, JS/CSS line comments inside <script>/<style> blocks,
and collapses inter-tag whitespace; prepends a component-manifest header
comment.  Conservative: string literals containing '//' (URLs) survive.
"""

from __future__ import annotations

import re
import sys


def _strip_js_comments(code: str) -> str:
    out = []
    in_str = None
    i = 0
    while i < len(code):
        c = code[i]
        if in_str:
            out.append(c)
            if c == "\\":
                if i + 1 < len(code):
                    out.append(code[i + 1])
                    i += 1
            elif c == in_str:
                in_str = None
            i += 1
            continue
        if c in "\"'`":
            in_str = c
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < len(code):
            if code[i + 1] == "/":
                while i < len(code) and code[i] != "\n":
                    i += 1
                continue
            if code[i + 1] == "*":
                end = code.find("*/", i + 2)
                i = len(code) if end < 0 else end + 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def minify_html(source: str, manifest: str = "") -> str:
    # HTML comments (keep conditional comments out of scope — none used)
    source = re.sub(r"<!--.*?-->", "", source, flags=re.S)

    def do_block(match):
        tag, body, close = match.group(1), match.group(2), match.group(3)
        body = _strip_js_comments(body)
        body = re.sub(r"\n\s*\n", "\n", body)
        return tag + body + close

    source = re.sub(r"(<script[^>]*>)(.*?)(</script>)", do_block, source,
                    flags=re.S)
    source = re.sub(r"(<style[^>]*>)(.*?)(</style>)", do_block, source,
                    flags=re.S)
    source = re.sub(r">\s+<", "><", source)
    source = re.sub(r"\n\s*\n", "\n", source)
    header = f"<!-- aegis_tpu SPA | {manifest} -->\n" if manifest else ""
    return header + source.strip()


def main() -> None:
    if len(sys.argv) < 2:
        print("usage: python -m aegis_tpu_torch.tools.minify_html <in.html> [out.html]")
        return
    src = open(sys.argv[1]).read()
    out = minify_html(src, manifest="upload/analyze/refilter/roll/tabs/studio")
    dst = sys.argv[2] if len(sys.argv) > 2 else sys.argv[1].replace(
        ".html", ".min.html")
    open(dst, "w").write(out)
    print(f"{len(src)} -> {len(out)} bytes ({dst})")


if __name__ == "__main__":
    main()
