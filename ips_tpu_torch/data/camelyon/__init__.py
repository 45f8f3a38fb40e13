from ips_tpu_torch.data.camelyon.dataset import CamelyonFeatures  # noqa: F401
