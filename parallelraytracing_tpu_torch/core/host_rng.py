"""Host-side deterministic RNG for scene construction.

The reference builds its RANDOM_BALLS presets with std::mt19937 seeded 1337
and std::uniform_real_distribution<float>
(src/core/scene.cpp:86-89).  We replicate MT19937 exactly
(numpy's legacy RandomState uses the same core generator but a different
float mapping), and map 32-bit draws to floats the way libstdc++'s
generate_canonical<float, 24> does — so the preset layouts are bit-stable
across runs and machines of THIS framework.  Exact layout parity with the
reference binary is not achievable portably (uniform_real_distribution is
implementation-defined), which only matters for cross-binary image diffs.
"""

from __future__ import annotations


class MT19937:
    """Minimal 32-bit Mersenne Twister (std::mt19937-compatible stream)."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        self.mt = [0] * self.N
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.index = self.N

    def _generate(self):
        mt = self.mt
        for i in range(self.N):
            y = (mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER)
            mt[i] = mt[(i + self.M) % self.N] ^ (y >> 1)
            if y & 1:
                mt[i] ^= self.MATRIX_A
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= self.N:
            self._generate()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF


class UniformSceneRng:
    """uniform_real_distribution<float>-style draws on MT19937, used by
    Scene presets (mirrors scene.cpp:86-89 usage)."""

    def __init__(self, seed: int = 1337):
        self._mt = MT19937(seed)

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        # generate_canonical<float, 24 bits>: one 32-bit draw, top 24 bits.
        u = (self._mt.next_u32() >> 8) * (1.0 / float(1 << 24))
        return lo + (hi - lo) * u
