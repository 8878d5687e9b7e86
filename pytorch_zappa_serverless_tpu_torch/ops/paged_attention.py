"""Block-paged KV primitives: gather a virtual cache, scatter token writes.

The JAX package's ``ops/paged_attention.py`` (jnp index ops there, torch
index ops here; neither is a Pallas kernel).  The paged lane stores K/V as
``[num_blocks, block_size, D]`` pages plus a per-sequence block table
``[S, max_blocks]``:

- :func:`gather_kv` materializes the **virtual cache**, the contiguous
  ``[S, max_blocks * block_size, D]`` view a table describes: virtual
  position ``j`` holds what position ``j``'s write stored, so attention over
  it equals attention over the slot pool's contiguous row at every position
  the row wrote.  Positions past a row's writes read its trailing (or the
  trash) pages; the caller's ``kpos <= wpos`` mask makes their softmax
  weights exact zeros.
- :func:`scatter_kv` routes per-token writes through the table: position
  ``p`` lands in page ``table[p // block_size]`` at offset
  ``p % block_size``.  Rows whose table is all ``TRASH_BLOCK`` (retired
  pool rows, the pad rows of a chunk group) write into the shared trash
  page.  Distinct sequences own distinct pages, so only trash-routed writes
  can collide, and no result that is kept reads them (a chunk group's pad
  row reads the trash page; its first token is dropped): a duplicate index
  in one ``index_put_`` is allowed there, and only there (on CUDA which
  duplicate wins is unspecified).
"""

from __future__ import annotations

import torch


def gather_kv(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pages [NB, BS, D], tables [S, MB] int → virtual cache [S, MB*BS, D]."""
    v = pages[tables.long()]  # [S, MB, BS, D]
    S, MB, BS, D = v.shape
    return v.reshape(S, MB * BS, D)


def paged_index(tables: torch.Tensor, positions: torch.Tensor,
                block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(page index, within-page offset), both int64, for absolute
    ``positions`` [S, T] under ``tables`` [S, MB]."""
    positions = positions.long()
    return (torch.gather(tables.long(), 1, positions // block_size),
            positions % block_size)


def scatter_kv(pages: torch.Tensor, tables: torch.Tensor, positions: torch.Tensor,
               values: torch.Tensor, block_size: int) -> torch.Tensor:
    """Write ``values`` [S, T, D] at absolute ``positions`` [S, T] through
    ``tables`` [S, MB] into ``pages`` [NB, BS, D] in place, and return it.
    Callers clip positions into ``[0, MB*BS)`` first."""
    bidx, off = paged_index(tables, positions, block_size)
    pages[bidx, off] = values.to(pages.dtype)
    return pages
