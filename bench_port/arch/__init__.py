"""One module for each architecture the benchmark runs, ``arch/<model_type>.py``,
found by the configuration file's ``model_type`` (``lib/common.py::arch_module``).
Everything the harness knows about an architecture is in its module and in its
plain reference; ``lib/`` and the kinds know none by name. A configuration of a
new architecture comes with new files only: ``configs/<name>.json``,
``arch/<model_type>.py``, ``reference/<reference>.py`` (where the existing
ones do not fit), a traffic mix, and reader files for its kernels' metrics.

An arch module provides, for a configuration file ``cfg`` (a dict):

- ``BACKEND``: the program's processor backend (``ImageProcessor(backend=...)``).
- ``sizes(cfg)``: the sizes the other functions read, from the file's layout.
- ``leaves(cfg)``: every parameter as a ``lib.weights.Leaf`` (name and shape as
  the program's ``state_dict`` has them, and how it is scaled), in the order of
  the stream of normals ``lib/weights.py`` draws from the seed; ``check_names``
  holds the table against the program's model.
- ``program_config(cfg, remat=False)``: the program's model configuration with
  every size set from the file.
- ``vocab(cfg)``: the text vocabulary.
- ``forward_flops(cfg, pages, query_lengths)``: model FLOPs of one forward over
  page layouts (``lib.model_work.page_layout``) and queries of these lengths.
- ``attention_calls(cfg, pages, query_lengths)``: that forward's attention
  calls, each (allowed pairs, heads, kv heads, head dim, valid rows), for
  ``lib.model_work.attention_least_s``.
- ``tiny(cfg)``: a copy of ``cfg`` with every size cut to what a CPU test holds
  (``tests/tiny.py``).

A module whose name starts with ``_`` holds pieces several architectures share
and is no ``model_type``'s.

Memory: serving set-up holds the model in its serving dtypes (the program's
meta model's) plus at most 0.5 GiB while the weights are drawn; the plain
reference holds it in f32, after the program is freed. So a configuration fits
one card when both of those, each with its activations, fit.

A reference module (``reference/<cfg["reference"]>.py``; plain PyTorch, f32,
nothing of the program imported; a new one may import the shared helpers of
``reference/colvlm.py``) provides to the kinds:

- ``process_page(image, cfg)``: a uint8 [H, W, 3] page to a dict with
  ``patches`` [N, P], ``segments`` [N] (windows or tiles) and
  ``n_image_tokens``, and what its ``page_vectors`` needs;
- ``prompt_ids(vocab)``: the page prompt's token ids;
- ``Reference(cfg, params, precision="f32")`` (``"fp8"``: the control) over the
  f32 leaves ``lib/weights.py`` draws, with ``.page(page, device)``: the page's
  l2-normalised token embeddings;
- ``page_vectors(emb, page)``: the stored vectors (``initial``, ``mean_pooling``,
  ``experimental_pooling``, ``global_pooling``) as numpy arrays;
- ``exact_f32()``: a context with f32 matmuls and no TF32;
- for training: ``train_steps(cfg, params, batches, lr, temperature,
  precision="f32", fault=None)``, ``infonce(q_embs, p_embs, temperature)``,
  ``embedding_gap(got, want)``, ``rounding_leaves(grad_norms)`` and
  ``leaf_gaps(got, want, skip)`` (``kinds/train.py`` says what each returns).

What a per-layer reader (``metrics/<name>.py``, ``read(facts)``) finds in
``facts``, the dict a kind hands back:

- every kind: ``trace`` (``lib.trace.DeviceTrace``) and ``window_s``; the
  program's spans are read through ``lib/spans.py``;
- ``search_batches``: ``batches``; traced, ``work`` (each batch's rerank bytes
  and operations, stage-1 bytes and operations) and ``rerank_impls``;
- ``ingest``: ``calls``; ``train``: ``steps``;
- ``ingest`` and ``train``, traced: ``config`` (the configuration file's dict),
  ``arch`` (its module), ``forwards`` (each timed forward as (page layouts,
  query lengths), in the order the window ran them), ``model_flops`` (the window's model FLOPs, the backward twice the forward),
  ``attention_least_s`` (the attention calls' least seconds) and
  ``attention_kernels`` (the name fragments of those kernels in the trace). A
  reader of a new kernel counts its work as
  ``facts["arch"].attention_calls(facts["config"], pages, query_lengths)`` does,
  over ``facts["forwards"]``.
"""
