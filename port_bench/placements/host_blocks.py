"""The rows as pageable host blocks of the traffic's ``block_rows``
(numpy arrays, copied from the device once in set-up), as a caller of
``fit_batched`` holds them.  The blocks that hold the rescaled rows are
copied once for each factor in set-up, so fit ``c``'s list is ready
before its timer starts."""

from port_bench.core.inputs import Inputs, vary_of


class HostBlocks(Inputs):
    def __init__(self, torch, host, vary, device):
        self._torch, self._device = torch, device
        self.n = sum(b.shape[0] for b in host)
        self.d = host[0].shape[1]
        self.itemsize = host[0].itemsize
        self.vary = vary
        self._lists = {}
        for f in vary.factors:
            blocks, start = [], 0
            for b in host:
                part = vary.overlap(start, start + b.shape[0])
                if part is not None:
                    b = b.copy()
                    b[part[0]:part[1]] *= f
                blocks.append(b)
                start += b.shape[0]
            self._lists[f] = blocks

    def prepare(self, c: int):
        self.arg = list(self._lists[self.vary.factor(c)])
        return self.arg

    def row_blocks(self, c: int):
        for b in self._lists[self.vary.factor(c)]:
            yield self._torch.from_numpy(b).to(self._device)


def make(torch, cfg, traffic, family, seed, device) -> HostBlocks:
    rows = int(traffic["block_rows"])
    host = []
    for blk in family.row_blocks(cfg, seed, device):
        host.extend(p.cpu().numpy() for p in blk.split(rows))
    return HostBlocks(torch, host, vary_of(traffic, int(cfg["data"]["n"]),
                                           seed), device)
