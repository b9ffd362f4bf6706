"""Utilities of the port: ``gradient_check`` (numerical gradient checking),
``backoff`` (the retry-delay policy), ``serialization`` (the model and
checkpoint zip both packages read and write), ``model_guesser``,
``archive`` (``unzip_file_to``), ``moving_window``
(``MovingWindowMatrix``) and ``viterbi`` (``Viterbi``, the most likely
label sequence)."""
