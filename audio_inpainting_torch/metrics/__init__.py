from .snr import snr_db, local_snr_db, lsd_db

__all__ = ["snr_db", "local_snr_db", "lsd_db"]
