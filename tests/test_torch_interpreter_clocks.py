"""The port's XML interpreter against the JAX package's on the five clock
tags (strict, discretized and continuous relaxed, local and random local
clocks) and the eleven prior tags, with the checks of
tests/test_torch_interpreter.py: the starting state, tree, log columns and
every posterior component at 6 states to 1e-10 relative, then 200 states
of the port's chain under the 0.1 full-evaluation check."""

import pytest
import torch

from test_torch_interpreter import (
    check_against_jax,
    check_chain,
    clock_and_prior_documents,
)

DOCS = clock_and_prior_documents()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread, which six test workers do not
    contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_matches_jax(name, tmp_path):
    check_against_jax(name, DOCS[name], tmp_path)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_document_chain_passes_full_evaluation(name, tmp_path):
    check_chain(name, DOCS[name], tmp_path)
