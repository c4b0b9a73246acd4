"""Tight variable-byte: LEB128-style with the terminator bit set on the
LAST byte (block_codecs.hpp:17-99 semantics — 7-bit groups little-endian
first, high bit marks the final byte)."""

import numpy as np


class TightVariableByte:
    @staticmethod
    def encode(values):
        """values -> bytes (numpy uint8 array)."""
        out = bytearray()
        for v in np.asarray(values, dtype=np.uint64):
            v = int(v)
            while True:
                byte = v & 0x7F
                v >>= 7
                if v == 0:
                    out.append(byte | 0x80)
                    break
                out.append(byte)
        return np.frombuffer(bytes(out), dtype=np.uint8)

    @staticmethod
    def encode_single(value, out_list):
        out_list.append(TightVariableByte.encode([value]))

    @staticmethod
    def decode(buf, pos, n):
        """Decode n values from buf starting at pos; returns (values, new_pos)."""
        out = np.empty(n, dtype=np.uint32)
        for i in range(n):
            shift = 0
            v = 0
            while True:
                c = int(buf[pos])
                pos += 1
                v += (c & 0x7F) << shift
                shift += 7
                if c & 0x80:
                    break
            out[i] = v
        return out, pos
