"""The selection menu of ``accelerate-tpu-torch config`` (the port of
`accelerate_tpu/commands/menu.py`).

`select(prompt, options)` draws an arrow-key menu on a terminal (raw-mode
reads, no curses) and falls back to a numbered prompt when stdin is not a
TTY, which is what makes the questionnaire scriptable.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

_UP = ("\x1b[A", "k")
_DOWN = ("\x1b[B", "j")
_ENTER = ("\r", "\n")
_INTERRUPT = ("\x03", "\x04", "\x1b")


def _read_key() -> str:
    import os
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        # os.read, NOT sys.stdin.read: the TextIOWrapper would slurp the whole
        # escape burst into its own buffer, making the select() peek below always
        # see an empty fd (every arrow would then look like a bare ESC).
        ch = os.read(fd, 1).decode(errors="replace")
        if ch == "\x1b":
            # Arrow keys arrive as a 3-byte burst; a bare ESC press arrives alone.
            # Peek instead of blocking so ESC can mean "cancel". os.read may
            # short-read when the burst splits across packets (slow links), so
            # keep reading until both continuation bytes arrive or the peek dries.
            while len(ch) < 3 and select.select([fd], [], [], 0.05)[0]:
                ch += os.read(fd, 3 - len(ch)).decode(errors="replace")
            if ch != "\x1b" and len(ch) < 3:
                ch = ""  # truncated burst: drop rather than misparse
        return ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def _render(options: Sequence[str], cursor: int, first: bool):
    if not first:
        sys.stdout.write(f"\x1b[{len(options)}A")  # move back up over the menu
    for i, opt in enumerate(options):
        marker = "➤" if i == cursor else " "
        line = f" {marker} {opt}"
        sys.stdout.write("\x1b[2K" + line + "\n")
    sys.stdout.flush()


def _arrow_menu(prompt: str, options: Sequence[str], default: int) -> int:
    print(prompt + " (arrows + enter)")
    cursor = default
    first = True
    while True:
        _render(options, cursor, first)
        first = False
        key = _read_key()
        if key in _UP:
            cursor = (cursor - 1) % len(options)
        elif key in _DOWN:
            cursor = (cursor + 1) % len(options)
        elif key in _ENTER:
            return cursor
        elif key in _INTERRUPT:
            raise KeyboardInterrupt
        elif key.isdigit() and int(key) < len(options):
            return int(key)


def _numbered_menu(prompt: str, options: Sequence[str], default: int) -> int:
    print(prompt)
    for i, opt in enumerate(options):
        print(f"  [{i}] {opt}")
    while True:
        raw = input(f"Selection [{default}]: ").strip()
        if not raw:
            return default
        try:
            idx = int(raw)
        except ValueError:
            print(f"Please enter a number 0..{len(options) - 1}")
            continue
        if 0 <= idx < len(options):
            return idx
        print(f"Please enter a number 0..{len(options) - 1}")


def select(prompt: str, options: Sequence[str], default: int = 0) -> int:
    """Return the index of the chosen option."""
    interactive = sys.stdin.isatty() and sys.stdout.isatty()
    if interactive:
        try:
            return _arrow_menu(prompt, options, default)
        except (ImportError, OSError):
            pass  # no termios (or odd terminal): fall through to numbered prompt
    return _numbered_menu(prompt, options, default)


def select_value(prompt: str, options: Sequence[str], default: Optional[str] = None) -> str:
    """Like `select`, returning the option string itself."""
    idx = options.index(default) if default in options else 0
    return options[select(prompt, options, idx)]
