"""API errors (k8s apierrors equivalents; port of ome_tpu/core/errors.py)."""


class APIError(Exception):
    pass


class NotFoundError(APIError):
    pass


class AlreadyExistsError(APIError):
    pass


class ConflictError(APIError):
    pass
