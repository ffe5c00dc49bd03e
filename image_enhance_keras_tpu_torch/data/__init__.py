"""Image file IO."""
