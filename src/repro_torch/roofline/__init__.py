"""Cost model of the port (counterpart of ``repro.roofline``): the H100
machine model (:mod:`~repro_torch.roofline.hw`), a count of the aten ops a
step dispatches (:mod:`~repro_torch.roofline.op_cost`), the roofline terms
built from it (:mod:`~repro_torch.roofline.analysis`) and the count's
calibration against ``torch.utils.flop_counter``
(:mod:`~repro_torch.roofline.calibrate`)."""
