"""The plain references the answers are judged against: WordPiece, the
encoder and the bi-encoder training steps, in f32 torch operations."""
