"""POSIX rand48 generator, used to reproduce the reference's deterministic
N -> random-base substitution (Index_src/bntseq.c:178-222: srand48(11),
c = lrand48() & 3 per ambiguous base)."""

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Rand48:
    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self.x = (_A * self.x + _C) & _MASK
        return self.x >> 17

    def lrand48_many(self, n: int):
        """Vector of n successive lrand48 values (python ints)."""
        out = []
        x = self.x
        for _ in range(n):
            x = (_A * x + _C) & _MASK
            out.append(x >> 17)
        self.x = x
        return out

    def drand48(self) -> float:
        """POSIX drand48: uniform double in [0, 1) from the full 48-bit
        state (exactly x / 2^48 — glibc builds the double from the high
        48 bits of the mantissa, which is the same value)."""
        self.x = (_A * self.x + _C) & _MASK
        return self.x / 281474976710656.0  # 2^48
