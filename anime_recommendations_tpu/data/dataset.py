"""Training dataset: split + static-shape minibatch iteration.

Split parity with neural_network.py:155-169: the frame is shuffled once with
seed 42 (inside get_df, :59), X/y are taken from that order, and the holdout
is simply the LAST ``test_size`` rows. (The reference's second shuffle with
seed 73 at :160 only feeds a shape read — its result is otherwise unused —
so it is not reproduced; SURVEY.md §3.2 records this as dead code.)

Static-shape iteration: every batch has the same static shape (XLA compiles
once). The final ragged batch is padded and carries a weight vector that
zeroes padded rows in the loss, matching Keras' inclusion of the remainder
batch without introducing dynamic shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import pandas as pd


@dataclass(frozen=True)
class Batch:
    users: np.ndarray    # int32 [B]
    anime: np.ndarray    # int32 [B]
    ratings: np.ndarray  # float32 [B]
    weights: np.ndarray  # float32 [B]; 0.0 marks padding


@dataclass
class RatingsDataset:
    users: np.ndarray
    anime: np.ndarray
    ratings: np.ndarray

    def __len__(self) -> int:
        return len(self.users)

    @classmethod
    def from_frame(cls, df: pd.DataFrame) -> "RatingsDataset":
        return cls(
            users=df["user"].to_numpy(np.int32),
            anime=df["anime"].to_numpy(np.int32),
            ratings=df["rating"].to_numpy(np.float32),
        )

    def num_batches(self, batch_size: int) -> int:
        return -(-len(self) // batch_size)

    def iter_batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
    ) -> Iterator[Batch]:
        n = len(self)
        idx = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(seed)
            rng.shuffle(idx)
        n_full = n // batch_size
        end_full = n_full * batch_size
        for start in range(0, end_full, batch_size):
            sel = idx[start:start + batch_size]
            yield Batch(
                users=self.users[sel],
                anime=self.anime[sel],
                ratings=self.ratings[sel],
                weights=np.ones(batch_size, np.float32),
            )
        rem = n - end_full
        if rem and not drop_remainder:
            sel = idx[end_full:]
            pad = batch_size - rem
            sel_padded = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            w = np.concatenate([np.ones(rem, np.float32), np.zeros(pad, np.float32)])
            yield Batch(
                users=self.users[sel_padded],
                anime=self.anime[sel_padded],
                ratings=self.ratings[sel_padded],
                weights=w,
            )


def shuffle_frame(df: pd.DataFrame, seed: int = 42) -> pd.DataFrame:
    """Reference get_df shuffle: df.sample(frac=1, random_state=seed)."""
    return df.sample(frac=1, random_state=seed)


def train_holdout_split(
    df: pd.DataFrame, test_size: int = 10_000, shuffle_seed: int = 42
) -> tuple[RatingsDataset, RatingsDataset]:
    """Shuffle with ``shuffle_seed``; last ``test_size`` rows become holdout."""
    df = shuffle_frame(df, seed=shuffle_seed)
    ds = RatingsDataset.from_frame(df)
    cut = max(len(ds) - int(test_size), 0)
    train = RatingsDataset(ds.users[:cut], ds.anime[:cut], ds.ratings[:cut])
    test = RatingsDataset(ds.users[cut:], ds.anime[cut:], ds.ratings[cut:])
    return train, test
