"""Analysis tools of the port: costs counted at the dispatcher
(``cost.py``, in place of the reference's HLO parser) and the roofline of
one H100 (``roofline.py``)."""
