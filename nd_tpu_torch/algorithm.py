"""Algorithm framework: the abstract base class of every datacube
operation, the ``njobs`` decorator and the functional-wrapper factory.

Counterpart of ``nd_tpu/algorithm.py``. ``njobs != 1`` splits the
Dataset along ``_parallel_dimension`` with the ``_buffer`` halo and maps
the chunks over a thread pool (:func:`nd_tpu_torch.utils.parallel`):
tensors on the card stay there, and every kernel wrapper is safe to call
from several threads.
"""

from __future__ import annotations

import inspect
from abc import ABC, abstractmethod
from functools import partial

from . import utils
from .tracing import span

__all__ = ['Algorithm', 'parallelize', 'wrap_algorithm']


class Algorithm(ABC):
    """Abstract base class for all datacube operations."""

    @abstractmethod
    def apply(self, ds):
        """Apply the algorithm to a Dataset."""
        return

    def _buffer(self, dim):
        """Halo width required when splitting along ``dim``."""
        return 0

    def _parallel_dimension(self, ds):
        """Dimension along which to split for parallel execution."""
        return 'y'


def parallelize(func):
    """Decorator: give an ``apply`` method an ``njobs`` kwarg.

    ``njobs == 1`` executes directly. Otherwise the dataset is split
    along ``self._parallel_dimension(ds)`` into ``njobs`` chunks (-1: the
    CPU count) with a ``self._buffer(dim)`` halo, mapped over threads,
    trimmed and concatenated: the result equals the unsplit call. Each
    call records the span ``'<Class>.apply'`` (:mod:`.tracing`).
    """

    def wrapper(self, ds, *args, njobs=1, **kwargs):
        method = partial(func, self)
        if njobs == -1:
            njobs = utils.ncpus()
        with span('%s.apply' % type(self).__name__):
            if njobs == 1:
                return method(ds, *args, **kwargs)
            dim = self._parallel_dimension(ds)
            return utils.parallel(method, dim=dim, chunks=njobs,
                                  buffer=self._buffer(dim))(ds, *args,
                                                            **kwargs)

    sig_func = inspect.signature(func)
    sig_wrapper = inspect.signature(wrapper)
    parameters = tuple(sig_func.parameters.values())
    parameters += (sig_wrapper.parameters['njobs'],)
    parameters = sorted(
        parameters, key=lambda p: (p.kind, p.default is not inspect._empty))
    new_parameters = []
    for p in parameters:
        if p not in new_parameters:
            new_parameters.append(p)
    sig = sig_func.replace(parameters=new_parameters)

    doc = utils.parse_docstring(func.__doc__)
    if 'Parameters' not in doc:
        doc['Parameters'] = []
    doc['Parameters'].append(
        ['njobs : int, optional',
         '    Number of chunks to process in parallel. -1 uses the',
         '    number of available cores. njobs=1 disables chunking',
         '    (default: 1).'])
    doc.setdefault('indent', 0)
    wrapper.__signature__ = sig
    wrapper.__doc__ = utils.assemble_docstring(doc, sig=sig)
    wrapper.__name__ = getattr(func, '__name__', 'apply')
    wrapper.__wrapped_apply__ = func
    return wrapper


def wrap_algorithm(algo, name=None):
    """Return the functional form of an Algorithm class.

    ``wrap_algorithm(NLMeansFilter, 'nlmeans')`` produces a function
    ``nlmeans(ds, **params)`` that instantiates the class with the
    constructor arguments and calls ``apply`` with the rest.
    """
    if not (inspect.isclass(algo) and issubclass(algo, Algorithm)):
        raise ValueError('Class must be derived from nd_tpu_torch.Algorithm.')

    def _wrapper(*args, **kwargs):
        apply_kwargs = utils.extract_arguments(algo.apply, args, kwargs)
        init_args = apply_kwargs.pop('args', ())
        init_kwargs = apply_kwargs.pop('kwargs', {})
        return algo(*init_args, **init_kwargs).apply(**apply_kwargs)

    _wrapper.__module__ = algo.__module__
    if name is not None:
        _wrapper.__name__ = name
        _wrapper.__qualname__ = name

    sig_init = inspect.signature(algo.__init__)
    sig_apply = inspect.signature(algo.apply)
    parameters = tuple(sig_apply.parameters.values())[1:] + \
        tuple(sig_init.parameters.values())[1:]
    parameters = sorted(
        parameters, key=lambda p: (p.kind, p.default is not inspect._empty))
    new_parameters = []
    for p in parameters:
        if p not in new_parameters:
            new_parameters.append(p)
    sig = sig_init.replace(parameters=new_parameters)
    _wrapper.__signature__ = sig

    link = ':class:`{}.{}`'.format(algo.__module__, algo.__name__)
    doc = utils.parse_docstring(algo.__doc__)
    doc.setdefault(None, ['', ''])
    doc[None].insert(0, 'Wrapper for {}.'.format(link))
    doc[None].insert(1, '')
    if algo.apply.__doc__ is not None:
        apply_doc = utils.parse_docstring(algo.apply.__doc__)
        if 'Parameters' in apply_doc:
            doc['Parameters'] = (apply_doc['Parameters']
                                 + doc.get('Parameters', []))
        if 'Returns' in apply_doc:
            doc['Returns'] = apply_doc['Returns']
    doc.setdefault('indent', 0)
    _wrapper.__doc__ = utils.assemble_docstring(doc, sig=sig)
    _wrapper.__algorithm__ = algo
    return _wrapper
