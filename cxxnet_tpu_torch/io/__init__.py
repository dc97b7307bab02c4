"""Data iterators of the PyTorch port (the port of ``cxxnet_tpu/io``).

The port's own copy of the iterator protocol (:class:`DataBatch`,
:class:`DataIter`), the in-memory batch cursor, the ``synthetic`` and
``synthetic_lm`` iterators, whose data is bit-equal to the JAX
package's from the same seeds (numpy draws it), and the ``mnist`` idx
reader, whose batches are bit-equal to the JAX package's.
:func:`create_iterator` builds an iterator from one config section; the
other iterator types (imgrec, imgbin, csv, threadbuffer, ...) raise,
naming ROADMAP Queue A 2.
"""

from .data import DataBatch, DataIter, create_iterator
from .iter_mnist import MNISTIterator
from .proc import SyntheticIterator, SyntheticLMIterator

__all__ = ["DataBatch", "DataIter", "MNISTIterator", "SyntheticIterator",
           "SyntheticLMIterator", "create_iterator"]
