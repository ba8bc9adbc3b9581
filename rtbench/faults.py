"""Faults planted under the timed path, to show that the comparison
catches them: each is a function of a ``harness.Program`` that breaks it
after its warm-up. A cell on one card has no exchange between chips to
leave out."""

from __future__ import annotations


class _Override:
    """A module with some of its functions replaced."""

    def __init__(self, module, **functions):
        self._module = module
        self.__dict__.update(functions)

    def __getattr__(self, name):
        return getattr(self._module, name)


def state_unchanged(prog) -> None:
    """The accumulation returns its state unchanged after the first
    batch."""
    frame = prog.frame

    def accumulate(acc, total, batch, n):
        if acc is None or total == 0:
            return frame.accumulate(acc, total, batch, n)
        return acc, total

    prog.frame = _Override(frame, accumulate=accumulate)


def half_batch(prog) -> None:
    """Each batch traces half of its samples, its mean taken over them."""
    render = prog.rt.render_device
    prog.rt.render_device = (lambda w, h, spp, depth, **kw:
                             render(w, h, max(1, spp // 2), depth, **kw))


def answer_altered(prog) -> None:
    """One value of each displayed frame is altered where the display
    stack produces it."""
    display = prog.display

    def display_stack(*args, **kw):
        stack = display.display_stack(*args, **kw).clone()
        stack[0, 0, 0, 0] = (int(stack[0, 0, 0, 0]) + 128) % 256
        return stack

    prog.display = _Override(display, display_stack=display_stack)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
