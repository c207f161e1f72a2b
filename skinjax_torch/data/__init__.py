"""Host-side data handling and on-device augmentation."""
