"""Serving in the port: the LM engine (``serve.engine``) and the DP-LASSO fit
service (``serve.fit_service``: ``FitService`` over ``solve_many``)."""
from repro_torch.serve.fit_service import (PRIVATE_QUEUES, FitRequest,  # noqa: F401
                                           FitService, FitServiceConfig)
