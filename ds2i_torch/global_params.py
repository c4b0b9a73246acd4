"""Serialized index-wide parameters.

Equivalent of the reference's global_parameters (global_parameters.hpp:5-31):
sampling rates for the Elias-Fano / ranked-bitvector skip pointers and the
uniform partition size. These travel inside the frozen index artifact so an
index is self-describing.
"""

from dataclasses import dataclass


@dataclass
class GlobalParameters:
    ef_log_sampling0: int = 9
    ef_log_sampling1: int = 8
    rb_log_rank1_sampling: int = 9
    rb_log_sampling1: int = 8
    log_partition_size: int = 7

    def tree(self):
        return {
            "ef_log_sampling0": self.ef_log_sampling0,
            "ef_log_sampling1": self.ef_log_sampling1,
            "rb_log_rank1_sampling": self.rb_log_rank1_sampling,
            "rb_log_sampling1": self.rb_log_sampling1,
            "log_partition_size": self.log_partition_size,
        }

    @classmethod
    def from_tree(cls, t):
        return cls(**{k: int(v) for k, v in t.items()})
