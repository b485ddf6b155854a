"""The prompt loop the three examples share."""
from __future__ import annotations


def read_move(prompt: str, sess):
    """The next line, stripped; ``new`` starts a new game (and shows it)
    and is read past; None at ``quit`` or the end of the input."""
    while True:
        try:
            raw = input(prompt).strip()
        except EOFError:
            return None
        if raw.lower() == "quit":
            return None
        if raw.lower() != "new":
            return raw
        sess.new_game()
        print(sess.show())
