"""The rows held whole on the device, as one tensor: ``fit(x)`` on a
matrix that lives on the card.  Fit ``c``'s rescaling is applied to the
tensor in place, by the ratio of its factor to the one it holds (a power
of two, so exact)."""

from port_bench.core.inputs import Inputs, vary_of


class OnDevice(Inputs):
    def __init__(self, x, vary, step: int):
        self.arg = x
        self.n, self.d = x.shape
        self.itemsize = x.element_size()
        self.vary = vary
        self._step = step
        self._held = 1.0  # the factor the tensor's block holds now

    def prepare(self, c: int):
        f = self.vary.factor(c)
        if f != self._held:
            self.arg[self.vary.lo:self.vary.hi] *= f / self._held
            self._held = f
        return self.arg

    def row_blocks(self, c: int):
        ratio = self.vary.factor(c) / self._held
        for i in range(0, self.n, self._step):
            blk = self.arg[i:i + self._step]
            part = self.vary.overlap(i, i + blk.shape[0])
            if part is not None and ratio != 1.0:
                blk = blk.clone()
                blk[part[0]:part[1]] *= ratio
            yield blk


def make(torch, cfg, traffic, family, seed, device) -> OnDevice:
    n, d = int(cfg["data"]["n"]), int(cfg["data"]["d"])
    x = torch.empty((n, d), dtype=getattr(torch, cfg["data"]["dtype"]),
                    device=device)
    row = 0
    for blk in family.row_blocks(cfg, seed, device):
        x[row:row + blk.shape[0]] = blk
        row += blk.shape[0]
    return OnDevice(x, vary_of(traffic, n, seed),
                    int(cfg["data"].get("gen_rows", n)))
