"""The configuration files of ``configuration/`` without a YAML package
(the card's machine has none): ``read_yaml`` parses the block-style subset
they use and gives what ``yaml.safe_load`` gives for them."""
from __future__ import annotations


def _scalar(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    return {"True": True, "False": False, "true": True, "false": False,
            "null": None, "~": None}.get(v, v)


def read_yaml(path: str) -> dict:
    """Nested mappings, block lists of scalars, scalars (int, float, bool,
    null, plain strings), "#" comments; a key with an empty value is None
    unless an indented block follows it."""
    root = {}
    stack = [[-1, root, None, None]]     # [indent, container, owner, key]
    with open(path) as f:
        lines = f.read().splitlines()
    for raw in lines:
        raw = raw.split(" #")[0].rstrip()
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        ind = len(raw) - len(raw.lstrip())
        line = raw.strip()
        while ind <= stack[-1][0]:
            stack.pop()
        top = stack[-1]
        if line.startswith("- "):
            if top[1] is None:               # "key:" followed by a list
                top[1] = top[2][top[3]] = []
            top[1].append(_scalar(line[2:].strip()))
            continue
        if top[1] is None:                   # "key:" followed by a mapping
            top[1] = top[2][top[3]] = {}
        key, _, val = line.partition(":")
        if val.strip():
            top[1][key] = _scalar(val.strip())
        else:
            top[1][key] = None
            stack.append([ind, None, top[1], key])
    return root
