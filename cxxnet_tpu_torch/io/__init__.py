"""Data iterators of the PyTorch port (the port of ``cxxnet_tpu/io``).

The port's own copy of the iterator protocol (:class:`DataBatch`,
:class:`DataIter`), the in-memory batch cursor, the ``synthetic`` and
``synthetic_lm`` iterators, whose data is bit-equal to the JAX
package's from the same seeds (numpy draws it), the ``mnist`` idx
reader, the ``imgrec`` image-record pipeline (record files, PNG and
JPEG decoding, the augmentations with the affine warp, the mean image,
uint8 batches for the input fold) and the ``img`` image-file iterator,
wrapped by the ``threadbuffer`` prefetcher, whose batches are the JAX
package's. :func:`create_iterator` builds an iterator chain from one
config section and :func:`close_chain` releases its threads; the other
iterator types (attachtxt, csv, membuffer, throttle) raise, naming
ROADMAP Queue A 2.
"""

from .data import DataBatch, DataIter, close_chain, create_iterator
from .iter_img import ImageIterator
from .iter_imgrec import ImageRecordIterator
from .iter_mnist import MNISTIterator
from .proc import SyntheticIterator, SyntheticLMIterator, ThreadBufferIterator

__all__ = ["DataBatch", "DataIter", "ImageIterator", "ImageRecordIterator", "MNISTIterator",
           "SyntheticIterator", "SyntheticLMIterator", "ThreadBufferIterator",
           "close_chain", "create_iterator"]
