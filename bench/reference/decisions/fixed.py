"""Decisions of the ``fixed`` variant (DistDGL with static prefetching),
worked out again from the rule the program states (``core/controller.py``'s
``FixedController``), importing nothing of the program: a replacement
round on every step of every PE. There is no agent, so no queue, no
memory and no margin."""


class Every:
    def new_call(self) -> None:
        pass

    def tick(self, t: int, m: dict, program=None, tie=None) -> tuple[bool, None, bool]:
        return True, None, False


def make(traffic: dict, num_pes: int, agent: dict | None = None, seed: int = 0):
    return [Every() for _ in range(num_pes)]
